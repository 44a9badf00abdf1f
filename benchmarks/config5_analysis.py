"""Config-5 (latent-distance, N=500) identifiability analysis.

VERDICT r1 task #3: is the weak link AUC (~0.66) a sampler/mixing problem
or a posterior ceiling? Protocol:

  A. truth-chain ceiling — run the GENERATING model's own Gibbs chain on
     its data, initialized AT the true parameters. Any AUC this chain's
     posterior-mean adjacency achieves is (an MC estimate of) the
     identifiability ceiling: no fitting chain can beat the posterior.
  B. fresh chain — same data, prior-initialized model, longer chain, with
     the HMC acceptance-rate diagnostic.

  C. --ess: the round-3 mixing-rate analysis (VERDICT r2 "config 5" item,
     option b). Run a fresh chain, trace scalar functionals of the position
     posterior (a fixed panel of logit-rho entries) plus the link AUC of a
     running posterior-mean adjacency, estimate each functional's
     integrated autocorrelation time tau (initial-positive-sequence
     estimator), and check that the AUC deficit tracks the ESS-predicted
     Monte-Carlo rate: AUC_ceiling - AUC(S) ~ c / sqrt(S / tau). If the
     fitted curve explains the trajectory, "slow transport" is a measured
     mixing rate, not a shrug — the chain is information-limited at the
     rate its own autocorrelation time predicts.

Run: python benchmarks/config5_analysis.py [--N 500] [--T 20000]
     [--ess | --long | --anneal]
Results are summarized in BASELINE.md.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def integrated_autocorr_time(x):
    """Initial-positive-sequence estimator of tau_int (Geyer 1992): sum
    consecutive autocovariance pairs while they stay positive."""
    x = np.asarray(x, np.float64)
    n = x.size
    x = x - x.mean()
    var = np.mean(x * x)
    if var <= 0:
        return 1.0
    acf = np.correlate(x, x, mode="full")[n - 1:] / (var * n)
    tau = 1.0
    k = 1
    while k + 1 < min(n, 2000):
        pair = acf[k] + acf[k + 1]
        if pair < 0:
            break
        tau += 2.0 * pair
        k += 2
    return float(max(tau, 1.0))


def run_ess(args):
    import pyglm_tpu as pt
    from pyglm_tpu.utils.metrics import link_auc

    N, T, S = args.N, args.T, args.sweeps
    true = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=5, net_kwargs=dict(dim=2, mu_bias=-3.0))
    Y = true.generate(T, keep=False)
    true_A = true.A.copy()
    model = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=0, net_kwargs=dict(dim=2))
    model.add_data(Y)

    rng = np.random.RandomState(0)
    ii = rng.randint(0, N, size=64)
    jj = rng.randint(0, N, size=64)

    lrho_trace = np.zeros((S, 64), np.float32)
    auc_points = []        # (sweep, windowed AUC)
    window = max(100, S // 16)
    A_win = np.zeros_like(true_A)
    n_win = 0
    t0 = time.time()
    for s in range(S):
        model.resample_model()
        st = model.state.net
        L = np.asarray(st.L)
        g = float(st.gamma)
        d2 = np.sum((L[ii] - L[jj]) ** 2, axis=-1)
        lrho_trace[s] = g - d2
        A_win += model.A
        n_win += 1
        if (s + 1) % window == 0:
            auc_points.append(
                [s + 1, float(link_auc(A_win / n_win, true_A))])
            A_win[:] = 0.0
            n_win = 0
        if (s + 1) % 500 == 0:
            print(f"sweep {s+1}/{S} ({time.time()-t0:.0f}s)", flush=True)

    # tau per traced functional, over the post-warmup half of the chain.
    half = S // 2
    taus = np.array([integrated_autocorr_time(lrho_trace[half:, k])
                     for k in range(64)])
    # ESS-rate fit: deficit(S) = c / sqrt(S / tau_med) on the AUC points
    # past the initial transient, against the truth-init ceiling.
    ceiling = args.ceiling
    tau_med = float(np.median(taus))
    pts = [(s, a) for s, a in auc_points if s >= S // 4]
    cs = [(ceiling - a) * np.sqrt(s / tau_med) for s, a in pts]
    c_hat = float(np.median(cs)) if cs else float("nan")
    pred = [[s, ceiling - c_hat / np.sqrt(s / tau_med)] for s, a in pts]
    resid = float(np.sqrt(np.mean(
        [(a - p[1]) ** 2 for (s, a), p in zip(pts, pred)]))) if pts else None

    out = {
        "mode": "ess", "N": N, "T": T, "sweeps": S,
        "tau_int_median": tau_med,
        "tau_int_p90": float(np.percentile(taus, 90)),
        "tau_int_max": float(np.max(taus)),
        "ess_total": float(half / tau_med),
        "auc_trajectory": auc_points,
        "ceiling": ceiling,
        "ess_rate_fit": {"c": c_hat, "rmse": resid,
                         "model": "auc = ceiling - c/sqrt(S/tau_med)"},
        "seconds": round(time.time() - t0, 1),
    }
    print(json.dumps(out))
    with open("config5_ess.json", "w") as f:
        json.dump(out, f, indent=1)


def run_long(args):
    """--long: out-of-sample test of the fitted mixing law (run_ess) on a
    chain several times longer than the 3000 sweeps the law was fitted to.

    The r3 ESS fit predicts AUC(S) = ceiling - c/sqrt(S/tau) with the
    heavy tau tail (p90 = 3.4x median) dragging long-S points below the
    single-tau curve; this mode measures where the real trajectory sits at
    S up to ~16k and whether/when it crosses 0.88 (VERDICT r2 'config 5'
    primary done-criterion). Sweeps run as on-device lax.scan segments
    (fit_compiled's shape — no per-sweep host dispatch; one (N, N)
    adjacency-sum copy to the host per segment)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import pyglm_tpu as pt
    from pyglm_tpu.utils.metrics import link_auc

    N, T, S = args.N, args.T, args.sweeps
    true = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=5, net_kwargs=dict(dim=2, mu_bias=-3.0))
    Y = true.generate(T, keep=False)
    true_A = true.A.copy()
    model = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=0, net_kwargs=dict(dim=2))
    model.add_data(Y)

    sweep = model._sweep
    datas = tuple(model.datas)
    seg_len = 200               # < fit_compiled's 250-sweep launch bound

    @partial(jax.jit, static_argnames=("length",))
    def seg(key, state, ds, length):
        def step(carry, k):
            s, acc = carry
            s, _ = sweep(k, s, ds)
            return (s, acc + s.A), None
        (s, acc), _ = jax.lax.scan(
            step, (state, jnp.zeros_like(state.A)),
            jax.random.split(key, length))
        return s, acc

    assert S % seg_len == 0, (S, seg_len)
    window = args.window
    assert window % seg_len == 0, (window, seg_len)
    burn = S // 4               # cumulative estimator discards this prefix

    state = model.state
    win_acc = np.zeros_like(true_A)
    win_n = 0
    cum_acc = np.zeros_like(true_A)
    cum_n = 0
    windowed = []               # [sweep, windowed AUC]
    cumulative = []             # [sweep, post-burn cumulative-mean AUC]
    t0 = time.time()
    for done in range(seg_len, S + 1, seg_len):
        state, acc = seg(model._next_key(), state, datas, length=seg_len)
        acc = np.asarray(acc)
        win_acc += acc
        win_n += seg_len
        if done > burn:
            cum_acc += acc
            cum_n += seg_len
        if win_n == window:
            windowed.append([done, float(link_auc(win_acc / win_n, true_A))])
            win_acc[:] = 0.0
            win_n = 0
            if cum_n:
                cumulative.append(
                    [done, float(link_auc(cum_acc / cum_n, true_A))])
            el = time.time() - t0
            print(f"sweep {done}/{S} ({el:.0f}s, {done/el:.1f}/s) "
                  f"win={windowed[-1][1]:.3f}"
                  + (f" cum={cumulative[-1][1]:.3f}" if cum_n else ""),
                  flush=True)
    el = time.time() - t0

    tau, c_hat = 75.5, 0.757    # config5_ess.json single-tau fit (r3)
    out = {
        "mode": "long", "N": N, "T": T, "sweeps": S, "window": window,
        "auc_windowed": windowed,
        "auc_cumulative_postburn": cumulative,
        "final_cumulative_auc": cumulative[-1][1] if cumulative else None,
        "ess_fit_prediction_at_end": float(
            args.ceiling - c_hat / np.sqrt(S / tau)),
        "ceiling": args.ceiling,
        "sweeps_per_sec": round(S / el, 2),
        "seconds": round(el, 1),
    }
    print(json.dumps(out))
    with open("config5_long.json", "w") as f:
        json.dump(out, f, indent=1)


def run_hmc_arms(args):
    """--hmc-arms: trajectory-length reallocation study at a FIXED gradient
    budget (hmc_iters * hmc_steps = 500 grads/sweep, the r3 default split).

    The r3 ESS analysis says config-5 AUC is bound by tau_int of the
    position functionals (median 75.5 sweeps at iters=10 x steps=50).
    With eps pinned by stability (0.15/sqrt(N)), each trajectory travels
    eps*steps ~ 0.34 — short relative to the sigma_l=1 embedding scale, so
    successive trajectories random-walk. HMC theory (and ChEES-style
    tuning) says ESS per gradient is maximized when the trajectory length
    matches the slowest posterior scale: fewer, longer trajectories may cut
    tau at identical cost. Arms reallocate the same 500-grad budget; each
    runs a compiled-scan chain tracing the 64-entry logit-rho panel (tau)
    and a windowed link AUC."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import pyglm_tpu as pt
    from pyglm_tpu.utils.metrics import link_auc

    N, T, S = args.N, args.T, args.sweeps
    true = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=5, net_kwargs=dict(dim=2, mu_bias=-3.0))
    Y = true.generate(T, keep=False)
    true_A = true.A.copy()

    rng = np.random.RandomState(0)
    ii = rng.randint(0, N, size=64)
    jj = rng.randint(0, N, size=64)
    ii_j = jnp.asarray(ii)
    jj_j = jnp.asarray(jj)

    arms = [tuple(map(int, a.split("x"))) for a in args.arms.split(",")]
    seg_len = 200
    assert S % seg_len == 0, (S, seg_len)
    window = max(seg_len, (S // 8) // seg_len * seg_len)
    results = []
    for iters, steps in arms:
        model = pt.NonlinearAutoregressiveModel(
            N, B=4, L=10, observation="bernoulli",
            network="latent_distance", spike_and_slab=True,
            seed=args.model_seed,
            net_kwargs=dict(dim=2, hmc_iters=iters, hmc_steps=steps))
        model.add_data(Y)
        sweep = model._sweep
        datas = tuple(model.datas)

        @partial(jax.jit, static_argnames=("length",))
        def seg(key, state, ds, length):
            def step(carry, k):
                s, acc = carry
                s, _ = sweep(k, s, ds)
                lrho = s.net.gamma - jnp.sum(
                    (s.net.L[ii_j] - s.net.L[jj_j]) ** 2, axis=-1)
                return (s, acc + s.A), lrho
            (s, acc), lrhos = jax.lax.scan(
                step, (state, jnp.zeros_like(state.A)),
                jax.random.split(key, length))
            return s, acc, lrhos

        state = model.state
        lrho_trace = np.zeros((S, 64), np.float32)
        win_acc = np.zeros_like(true_A)
        win_n = 0
        auc_points = []
        t0 = time.time()
        for done in range(seg_len, S + 1, seg_len):
            state, acc, lrhos = seg(
                model._next_key(), state, datas, length=seg_len)
            lrho_trace[done - seg_len:done] = np.asarray(lrhos)
            win_acc += np.asarray(acc)
            win_n += seg_len
            if win_n == window:
                auc_points.append(
                    [done, float(link_auc(win_acc / win_n, true_A))])
                win_acc[:] = 0.0
                win_n = 0
        el = time.time() - t0
        half = S // 2
        taus = np.array([integrated_autocorr_time(lrho_trace[half:, k])
                         for k in range(64)])
        res = {
            "iters": iters, "steps": steps, "grads": iters * steps,
            "tau_int_median": float(np.median(taus)),
            "tau_int_p90": float(np.percentile(taus, 90)),
            "tau_int_max": float(np.max(taus)),
            "auc_trajectory": auc_points,
            "final_window_auc": auc_points[-1][1] if auc_points else None,
            "sweeps_per_sec": round(S / el, 2),
            "seconds": round(el, 1),
        }
        print(json.dumps(res), flush=True)
        results.append(res)

    with open(args.arms_out, "w") as f:
        json.dump({"mode": "hmc_arms", "N": N, "T": T, "sweeps": S,
                   "window": window, "model_seed": args.model_seed,
                   "arms": results}, f, indent=1)


def run_anneal(args):
    """--anneal: tempered (power-likelihood) burn-in vs a control chain.

    Bernoulli^beta stays exactly in the PG family: p(y|psi)^beta =
    exp(beta y psi) / (1+e^psi)^beta  =>  omega ~ PG(beta, psi), kappa =
    beta (y - 1/2) — so the collapsed spike-and-slab machinery is unchanged
    and the post-burn-in chain (beta = 1) is the standard exact sampler.
    beta rides in the observation's aux (a traced leaf of the state pytree),
    so ramping it costs zero recompiles. The hope: with a flat likelihood
    early, (A, L) explores near the prior and settles adiabatically as beta
    ramps, transporting the embedding faster than the quasi-static beta=1
    chain (round-2's three mode-escape interventions were all negative;
    this is the fourth candidate, VERDICT r2 'config 5' untried list)."""
    from dataclasses import dataclass

    import jax
    import jax.numpy as jnp
    import pyglm_tpu as pt
    from pyglm_tpu.ops.polyagamma import polya_gamma
    from pyglm_tpu.utils.metrics import link_auc

    from pyglm_tpu.models.observations import _FamilyBase

    # Inherits _FamilyBase so the family satisfies the full observation
    # protocol the sweep builder calls (ll_cache at add_data,
    # log_likelihood_sum and resample_aux(cache=) inside the sweep) —
    # the r4 ll_cache contract broke the bare duck-typed class (ADVICE r4).
    @dataclass(frozen=True)
    class TemperedBernoulli(_FamilyBase):
        name: str = "bernoulli_tempered"
        needs_pg: bool = True

        def init_aux(self, N):
            return {"beta": jnp.float32(1.0)}

        def omega_kappa(self, key, Y, psi, aux):
            beta = aux["beta"]
            b = jnp.broadcast_to(beta, psi.shape)
            omega = polya_gamma(key, b, psi, method="real")
            return omega, beta * (Y - 0.5)

        def log_likelihood(self, Y, psi, aux):   # untempered, for reporting
            return Y * psi - jax.nn.softplus(psi)

        def sample(self, key, psi, aux):
            return jax.random.bernoulli(
                key, jax.nn.sigmoid(psi)).astype(jnp.float32)

        def mean(self, psi, aux):
            return jax.nn.sigmoid(psi)

        def resample_aux(self, key, aux, Y, psi, cache=None):
            return aux

    N, T, S = args.N, args.T, args.sweeps
    ramp = args.ramp
    true = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=5, net_kwargs=dict(dim=2, mu_bias=-3.0))
    Y = true.generate(T, keep=False)
    true_A = true.A.copy()

    def run_arm(label, obs, schedule):
        model = pt.NonlinearAutoregressiveModel(
            N, B=4, L=10, observation=obs, network="latent_distance",
            spike_and_slab=True, seed=0, net_kwargs=dict(dim=2))
        model.add_data(Y)
        window = 100
        A_win = np.zeros_like(true_A)
        n_win = 0
        pts = []
        t0 = time.time()
        for s in range(S):
            if schedule is not None:
                model.state = model.state._replace(
                    aux={"beta": jnp.float32(schedule(s))})
            model.resample_model()
            A_win += model.A
            n_win += 1
            if (s + 1) % window == 0:
                pts.append([s + 1, float(link_auc(A_win / n_win, true_A))])
                A_win[:] = 0.0
                n_win = 0
        out = {"label": label, "auc_trajectory": pts,
               "seconds": round(time.time() - t0, 1)}
        print(json.dumps(out), flush=True)
        return out

    sched = (lambda s: float(min(1.0, args.beta0
                                 + (1.0 - args.beta0) * s / ramp)))
    arms = [run_arm("anneal", TemperedBernoulli(), sched),
            run_arm("control", "bernoulli", None)]
    with open("config5_anneal.json", "w") as f:
        json.dump({"N": N, "T": T, "sweeps": S, "ramp": ramp,
                   "beta0": args.beta0, "arms": arms}, f, indent=1)


def chain_auc(model, true_A, n_burn, n_avg, label):
    from pyglm_tpu.utils.metrics import link_auc
    accepts = []
    for _ in range(n_burn):
        d = model.resample_model()
        accepts.append(d.get("hmc_accept", np.nan))
    A_acc = np.zeros_like(true_A)
    for _ in range(n_avg):
        d = model.resample_model()
        accepts.append(d.get("hmc_accept", np.nan))
        A_acc += model.A / n_avg
    auc = float(link_auc(A_acc, true_A))
    out = {"label": label, "auc": auc,
           "hmc_accept_mean": float(np.nanmean(accepts)),
           "n_burn": n_burn, "n_avg": n_avg}
    print(json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=500)
    ap.add_argument("--T", type=int, default=20_000)
    ap.add_argument("--burn-fresh", type=int, default=300)
    ap.add_argument("--avg", type=int, default=100)
    ap.add_argument("--ess", action="store_true",
                    help="mixing-rate (tau/ESS) analysis instead of A/B")
    ap.add_argument("--long", dest="long_run", action="store_true",
                    help="compiled-scan long chain: out-of-sample test of "
                         "the ESS mixing law; AUC vs 0.88")
    ap.add_argument("--window", type=int, default=800,
                    help="--long: posterior-mean window (sweeps)")
    ap.add_argument("--anneal", action="store_true",
                    help="tempered-burn-in vs control experiment")
    ap.add_argument("--hmc-arms", dest="hmc_arms", action="store_true",
                    help="budget-matched HMC trajectory-length study")
    ap.add_argument("--arms", type=str, default="10x50,4x125,2x250,1x500",
                    help="--hmc-arms: comma list of itersxsteps splits")
    ap.add_argument("--model-seed", type=int, default=0,
                    help="--hmc-arms: fitting-model init seed")
    ap.add_argument("--arms-out", type=str, default="config5_hmc_arms.json")
    ap.add_argument("--ramp", type=int, default=600,
                    help="--anneal: sweeps over which beta ramps to 1")
    ap.add_argument("--beta0", type=float, default=0.2,
                    help="--anneal: starting inverse temperature")
    ap.add_argument("--sweeps", type=int, default=3000)
    ap.add_argument("--ceiling", type=float, default=0.962,
                    help="truth-init ceiling AUC (BASELINE.md)")
    args = ap.parse_args()

    import jax
    from pyglm_tpu.utils.utils import enable_compile_cache
    enable_compile_cache()
    if args.ess:
        run_ess(args)
        return
    if args.long_run:
        run_long(args)
        return
    if args.anneal:
        run_anneal(args)
        return
    if args.hmc_arms:
        run_hmc_arms(args)
        return
    import pyglm_tpu as pt

    N, T = args.N, args.T
    true = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=5,
        net_kwargs=dict(dim=2, mu_bias=-3.0))
    Y = true.generate(T, keep=False)
    true_A = true.A.copy()
    print(json.dumps({"N": N, "T": T, "rate": float(Y.mean()),
                      "true_density": float(true_A.mean())}))

    # A. truth-initialized chain = identifiability ceiling.
    true.add_data(Y)
    t0 = time.time()
    res_a = chain_auc(true, true_A, n_burn=30, n_avg=args.avg,
                      label="truth_init_ceiling")
    print(f"phase A: {time.time()-t0:.0f}s")

    # B. fresh chain, longer burn.
    model = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=0, net_kwargs=dict(dim=2))
    model.add_data(Y)
    t0 = time.time()
    res_b = chain_auc(model, true_A, n_burn=args.burn_fresh, n_avg=args.avg,
                      label="fresh_long")
    print(f"phase B: {time.time()-t0:.0f}s")

    with open("config5_analysis.json", "w") as f:
        json.dump({"N": N, "T": T, "truth_init": res_a, "fresh": res_b}, f,
                  indent=1)


if __name__ == "__main__":
    main()
