"""Acceptance harness + GATE: the five BASELINE.json configs, end-to-end.

For each config: build a ground-truth model, simulate spikes, fit a fresh
model by Gibbs, and report recovery quality (link AUC, weight correlation,
held-out predictive LL vs the generating model) plus sweeps/sec. Writes one
JSON report and exits non-zero if any per-config threshold fails (full
mode only; --quick runs chains too short to gate). Reference-posterior
parity is blocked on the empty reference mount (SURVEY.md); ground-truth
recovery is the operative parity check.

Run: python benchmarks/acceptance.py [--quick] [--out report.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# Pass/fail contract (BASELINE.json north_star parity clause). These gates
# are REGRESSION FLOORS, not independent parity evidence: each value is the
# measured round-1/round-2 result minus a Monte-Carlo margin, so a failure
# means a conditional/sampler regression shipped, not MC noise. (True
# reference-posterior parity remains blocked on the empty reference mount;
# the independent exactness evidence lives in the Geweke + NumPy-oracle +
# native-PG-KS test suites.) Config 5's AUC floor is additionally tied to
# the ceiling analysis in BASELINE.md: the truth-initialized posterior
# ceiling is 0.962; the gated pooled-ensemble estimator's 0.86 floor is
# ~90% of that ceiling (see the cfg5 threshold comment below).
THRESHOLDS = {
    # Floors retuned 2026-08-18 after the chains were extended (100+30 ->
    # 500+150, cfg2 400+100 -> 1200+300): at scanned-driver speeds the
    # longer chains cost seconds and the measured recoveries sit at their
    # ceilings — cfg2 AUC 0.899 (truth-init ceiling 0.898), cfg3 0.962,
    # cfg4 0.965, predictive-LL gaps 0.0008-0.0016/bin. Floors are the
    # measured values minus an MC margin.
    "1_bernoulli_dense": {
        "weight_corr": (">=", 0.75), "pred_ll_gap_per_bin": ("<=", 0.002)},
    "2_negative_binomial": {
        "link_auc": (">=", 0.86), "weight_corr": (">=", 0.85),
        "pred_ll_gap_per_bin": ("<=", 0.003)},
    "3_spike_slab": {
        "link_auc": (">=", 0.93), "weight_corr": (">=", 0.93),
        "pred_ll_gap_per_bin": ("<=", 0.004)},
    "4_sbm": {
        "link_auc": (">=", 0.93), "weight_corr": (">=", 0.93),
        "pred_ll_gap_per_bin": ("<=", 0.004)},
    # cfg5 is gated on the measured-best estimator (VERDICT r4 next #2):
    # the POOLED-ENSEMBLE posterior mean over C=8 prior-initialized
    # chains run as one lane-stacked sweep (fit_ensemble collect="mean",
    # 1200 burn + 1200 averaged). The round-4 PT study measured the
    # pooled 8-chain window estimator at AUC 0.875 (2100-2400 window)
    # vs 0.823 for the single chain at matched FLOPs (BASELINE.md
    # config-5 round 4; config5_pt.json), and cumulative 1200-2400
    # averaging only improves on the last window. Floor = 0.875 minus
    # an MC margin. Single-chain history: the 3000+300 chain gated 0.80
    # through r4 (mixing law 0.962 - 0.757/sqrt(S/75.5)).
    "5_latent_distance": {
        "link_auc": (">=", 0.86), "weight_corr": (">=", 0.60),
        "pred_ll_gap_per_bin": ("<=", 0.040)},
}


def check_gates(results):
    """Evaluate per-config thresholds. Returns (passed, failures)."""
    failures = []
    for res in results:
        for prefix, gates in THRESHOLDS.items():
            if not res["config"].startswith(prefix):
                continue
            for metric, (op, bound) in gates.items():
                if metric not in res:
                    failures.append(f"{res['config']}: metric {metric} missing")
                    continue
                v = res[metric]
                ok = v >= bound if op == ">=" else v <= bound
                if not ok:
                    failures.append(
                        f"{res['config']}: {metric}={v:.4f} violates "
                        f"{op} {bound}")
    return (not failures), failures


def _score(model, true, A_mean, Weff_mean, Y_test):
    from pyglm_tpu.utils.metrics import link_auc
    out = {}
    if true.A.min() < 1:     # sparse truth -> AUC meaningful
        out["link_auc"] = float(link_auc(A_mean, true.A))
    mask = true.A.astype(bool)
    if mask.sum() > 2:
        out["weight_corr"] = float(np.corrcoef(
            Weff_mean[mask], true.W_effective[mask])[0, 1])
    out["pred_ll_model"] = float(model.log_likelihood(Y_test))
    out["pred_ll_truth"] = float(true.log_likelihood(Y_test))
    out["pred_ll_gap_per_bin"] = float(
        (out["pred_ll_truth"] - out["pred_ll_model"]) / Y_test.size)
    return out


def run_config(name, true, model, T_train, T_test, n_burn, n_avg):
    """Fit one config with the chain scanned ON DEVICE (fit_compiled's
    shape): burn-in as one compiled lax.scan, then an averaging scan that
    accumulates posterior means of A and W_effective, with no per-sweep
    host dispatch. sweeps_per_sec here is the burn chunks' wall time
    (compile excluded via a discarded warmup chunk); posterior means
    accumulate in the scan carry, so memory is O(state)."""
    import jax
    import jax.numpy as jnp
    Y = true.generate(T_train + T_test, keep=False)
    Y_train, Y_test = Y[:T_train], Y[T_train:]
    model.add_data(Y_train)
    sweep = model._sweep

    # Burn in chunks of <=250 sweeps (one compile: the length repeats).
    n_chunk = min(max(n_burn, 1), 250)
    n_chunks, rem = divmod(n_burn, n_chunk)

    def burn(key, state, datas, length):
        def step(s, k):
            s, _ = sweep(k, s, datas)
            return s, None
        return jax.lax.scan(step, state, jax.random.split(key, length))[0]

    def avg(key, state, datas, accA, accW, length):
        def step(carry, k):
            s, aA, aW = carry
            s, _ = sweep(k, s, datas)
            weff = jnp.sum(s.A[:, :, None] * s.W, axis=-1)
            return (s, aA + s.A, aW + weff), None
        (state, accA, accW), _ = jax.lax.scan(
            step, (state, accA, accW), jax.random.split(key, length))
        return state, accA, accW

    datas = tuple(model.datas)
    burn_j = jax.jit(burn, static_argnames=("length",))
    burn_j(model._next_key(), model.state, datas,
           length=n_chunk)                           # compile
    t0 = time.time()
    state = model.state
    for _ in range(n_chunks):
        state = burn_j(model._next_key(), state, datas, length=n_chunk)
    jax.block_until_ready(state)
    sweep_time = (time.time() - t0) / (n_chunks * n_chunk)
    if rem:
        state = burn_j(model._next_key(), state, datas, length=rem)
    model.state = state
    accA = jnp.zeros((model.N, model.N), jnp.float32)
    accW = jnp.zeros((model.N, model.N), jnp.float32)
    avg_j = jax.jit(avg, static_argnames=("length",))
    left = n_avg
    while left > 0:
        c = min(left, 250)
        model.state, accA, accW = avg_j(
            model._next_key(), model.state, datas, accA, accW, length=c)
        left -= c
    A_mean, Weff_mean = accA / n_avg, accW / n_avg
    res = {"config": name, "N": true.N, "T": T_train,
           "rate": float(Y_train.mean()),
           "sweeps_per_sec": round(1.0 / sweep_time, 3)}
    res.update(_score(model, true, np.asarray(A_mean),
                      np.asarray(Weff_mean), Y_test))
    print(json.dumps(res))
    return res


def run_config5_ensemble(name, true, model, T_train, T_test,
                         n_burn, n_avg, n_chains):
    """Fit config 5 with the measured-best estimator: the POOLED-ENSEMBLE
    posterior mean over C prior-initialized chains run as one lane-stacked
    sweep (fit_ensemble collect='mean'; BASELINE.md config-5 round 4 —
    pooled 8 chains AUC 0.875 vs 0.823 single at matched FLOPs). Budget
    accounting: C*(n_burn+n_avg) lane-chain sweeps; the compiled stacked
    sweep runs ~C*N lanes at near single-chain per-lane cost."""
    import jax.numpy as jnp
    Y = true.generate(T_train + T_test, keep=False)
    Y_train, Y_test = Y[:T_train], Y[T_train:]
    model.add_data(Y_train)
    t0 = time.time()
    ens = model.fit_ensemble(n_chains=n_chains, n_samples=n_avg,
                             n_burnin=n_burn, collect="mean")
    el = time.time() - t0
    # pred-LL from one chain's final state — a legitimate posterior draw,
    # matching the single-chain protocol's "state after the avg scan"
    model.state = ens["final_states"][0]
    res = {"config": name, "N": true.N, "T": T_train,
           "rate": float(Y_train.mean()),
           "estimator": f"pooled-ensemble C={n_chains} "
                        f"({n_burn}+{n_avg} sweeps/chain)",
           "rhat_ll": ens["rhat_ll"],
           "stacked_sweeps_per_sec": round((n_burn + n_avg) / el, 3),
           "chain_sweeps_per_sec": round(
               n_chains * (n_burn + n_avg) / el, 3),
           "seconds_incl_compile": round(el, 1)}
    res.update(_score(model, true, np.asarray(ens["A_mean_pooled"]),
                      np.asarray(ens["Weff_mean_pooled"]), Y_test))
    print(json.dumps(res))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small T / few sweeps (CI smoke)")
    ap.add_argument("--out", default=None,
                    help="report path (default: acceptance_report.json, or "
                         "acceptance_report_partial.json with --only)")
    ap.add_argument("--only", default=None, metavar="SUBSTR",
                    help="run only configs whose name contains SUBSTR; the "
                         "partial report goes to acceptance_report_partial"
                         ".json unless --out is given explicitly")
    ap.add_argument("--precision", default="high",
                    choices=("high", "default"),
                    help="fitted models' precision mode (the truth models "
                         "always generate at 'high'); the same gates apply "
                         "— a PASS at 'default' certifies the TF32 speed "
                         "point end-to-end")
    args = ap.parse_args()
    if args.out is None:
        args.out = ("acceptance_report_partial.json" if args.only
                    else "acceptance_report.json")
        if args.precision != "high" and not args.only:
            args.out = f"acceptance_report_{args.precision}.json"

    def want(name):
        return args.only is None or args.only in name

    import jax
    from pyglm_tpu.utils.utils import enable_compile_cache
    enable_compile_cache()
    import pyglm_tpu as pt

    q = args.quick
    prec = args.precision
    # The chains run scanned on device, so 500+150 sweeps cost seconds
    # and buy tighter regression floors than short chains would.
    n_burn, n_avg = (10, 5) if q else (500, 150)
    results = []

    # 1. Bernoulli GLM, dense weights, ER-style shared weight prior.
    if want("1_bernoulli_dense"):
        N, T = 27, (5_000 if q else 60_000)
        true = pt.BernoulliGLM(N, B=4, L=10, seed=1, net_kwargs=dict(
            sigma_w=0.05, mu_bias=-2.5, learn_weight_prior=False))
        model = pt.BernoulliGLM(N, B=4, L=10, seed=0, precision=prec)
        results.append(run_config("1_bernoulli_dense", true, model,
                                  T, T // 10, n_burn, n_avg))

    # 2. Negative-binomial observations with PG augmentation.
    if want("2_negative_binomial"):
        N, T = 50, (4_000 if q else 20_000)
        true = pt.SparseNegativeBinomialGLM(
            N, B=4, L=10, seed=2,
            obs_kwargs=dict(r_init=5.0, resample_r=False, max_y=256),
            net_kwargs=dict(rho_init=0.1, learn_rho=False))
        model = pt.SparseNegativeBinomialGLM(
            N, B=4, L=10, seed=0, precision=prec,
            obs_kwargs=dict(max_y=256))
        results.append(run_config("2_negative_binomial", true, model,
                                  T, T // 10,
                                  (10 if q else 1200), (5 if q else 300)))

    # 3. Spike-and-slab joint (A, W) Gibbs.
    if want("3_spike_slab"):
        N, T = 100, (5_000 if q else 40_000)
        true = pt.SparseBernoulliGLM(N, B=4, L=10, seed=3, net_kwargs=dict(
            rho_init=0.08, learn_rho=False, mu_bias=-2.5, sigma_bias=0.2,
            learn_weight_prior=False, sigma_w=1.5))
        model = pt.SparseBernoulliGLM(N, B=4, L=10, seed=0,
                                      precision=prec)
        results.append(run_config("3_spike_slab", true, model,
                                  T, T // 10, n_burn, n_avg))

    # 4. SBM network prior with block resampling.
    if want("4_sbm"):
        N, K, T = 100, 5, (5_000 if q else 40_000)
        true = pt.NonlinearAutoregressiveModel(
            N, B=4, L=10, observation="bernoulli", network="sbm",
            spike_and_slab=True, seed=4,
            net_kwargs=dict(K=K, rho_init=0.1, mu_bias=-2.5))
        model = pt.NonlinearAutoregressiveModel(
            N, B=4, L=10, observation="bernoulli", network="sbm",
            spike_and_slab=True, seed=0, precision=prec,
            net_kwargs=dict(K=K))
        results.append(run_config("4_sbm", true, model,
                                  T, T // 10, n_burn, n_avg))

    # 5. Latent-distance prior; sharded over all available devices. Both
    # branches use the SAME estimator budget: the 0.86 AUC floor is tied
    # to the pooled-ensemble protocol (C=8, 1200+1200), so a different
    # budget would be gated against the wrong prediction.
    n_burn5, n_avg5, C5 = (10, 5, 4) if q else (1200, 1200, 8)
    if want("5_latent_distance"):
        N, T = 500, (4_000 if q else 20_000)
        true = pt.NonlinearAutoregressiveModel(
            N, B=4, L=10, observation="bernoulli", network="latent_distance",
            spike_and_slab=True, seed=5,
            net_kwargs=dict(dim=2, mu_bias=-3.0))
        model = pt.NonlinearAutoregressiveModel(
            N, B=4, L=10, observation="bernoulli", network="latent_distance",
            spike_and_slab=True, seed=0, precision=prec,
            net_kwargs=dict(dim=2))
        if len(jax.devices()) > 1:
            # Multi-device: the same pooled-ensemble estimator, with the
            # chains spread over a ('chain',) device mesh (or composed
            # chain-data when the device count allows a 3-D mesh) —
            # the acceptance suite regression-guards the mesh machinery.
            from pyglm_tpu.parallel.sharding import (make_chain_data_mesh,
                                                     make_chain_mesh)
            D = len(jax.devices())
            if D >= 8 and C5 % 2 == 0 and N % 2 == 0 and T % 2 == 0:
                mesh5 = make_chain_data_mesh(2, 2, 2)
            else:
                mesh5 = make_chain_mesh(min(C5, D))
            Y = true.generate(T + T // 10, keep=False)
            model.add_data(Y[:T])
            t0 = time.time()
            ens = model.fit_ensemble(n_chains=C5, n_samples=n_avg5,
                                     n_burnin=n_burn5, collect="mean",
                                     mesh=mesh5)
            el = time.time() - t0
            model.state = ens["final_states"][0]
            res5 = {"config": "5_latent_distance_sharded",
                    "mesh": dict(mesh5.shape),
                    "estimator": f"pooled-ensemble C={C5} "
                                 f"({n_burn5}+{n_avg5} sweeps/chain)",
                    "rhat_ll": ens["rhat_ll"],
                    "stacked_sweeps_per_sec": round(
                        (n_burn5 + n_avg5) / el, 3)}
            res5.update(_score(model, true,
                               np.asarray(ens["A_mean_pooled"]),
                               np.asarray(ens["Weff_mean_pooled"]), Y[T:]))
            print(json.dumps(res5))
            results.append(res5)
        else:
            # Estimator switched r5 (VERDICT r4 next #2): the round-4 PT
            # study measured the pooled 8-chain posterior mean at AUC
            # 0.875 vs 0.823 for the matched-FLOPs single chain — the
            # ensemble IS the measured-best estimator at this scale, and
            # gating it regression-guards fit_ensemble/collect="mean"
            # end-to-end. (Single-chain history: 3000+300 gated 0.80 by
            # the mixing law 0.962 - 0.757/sqrt(S/75.5) through r4.)
            results.append(run_config5_ensemble(
                "5_latent_distance_ensemble", true, model, T, T // 10,
                n_burn5, n_avg5, C5))

    if not results:
        print(f"no config matches --only {args.only!r}; nothing ran")
        sys.exit(2)

    passed, failures = check_gates(results)
    report = {"quick": q, "results": results,
              "threshold_semantics": (
                  "regression floors: measured r1/r2 values minus an MC "
                  "margin, detecting sampler regressions; not independent "
                  "reference-parity evidence (see module docstring)"),
              "thresholds": {k: {m: list(g) for m, g in v.items()}
                             for k, v in THRESHOLDS.items()},
              "gate": {"evaluated": not q, "passed": passed,
                       "failures": failures}}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    if q:
        print("gate: skipped (--quick chains are too short to judge)")
        return
    if passed:
        print("gate: PASS")
    else:
        print("gate: FAIL")
        for f_ in failures:
            print("  " + f_)
        sys.exit(1)


if __name__ == "__main__":
    main()
