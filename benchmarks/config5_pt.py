"""Config-5 parallel tempering study (VERDICT r3 next-round item #1).

The r3 mixing analysis measured tau_int ~ 75 sweeps for the latent-distance
position functionals and nulled five within-chain interventions; parallel
tempering is the one untried EXACT move family. This study runs it on the
lane-stacked machinery (models/tempering.py):

  control — the standard single chain (the r3 protocol: compiled-scan
      segments tracing a 64-entry logit-rho panel + windowed link AUC).
      Its post-burn-in lls trace measures sd(ll), the posterior
      fluctuation scale of the untempered log-likelihood that governs
      swap acceptance: adjacent rungs at gap d accept ~ erfc(d*sd/2).
  arm span — C rungs spanning beta in [0.3, 1]: the ladder any tempering
      argument wants. Predicted (and measured) swap acceptance ~ 0 at this
      model's sd(ll), making the rungs independent chains.
  arm feasible — C rungs at the gap that DOES accept (~30%+), i.e. a
      ladder spanning only ~C*2.4/sd(ll) of the unit interval.
  arm ensemble — C INDEPENDENT untempered chains (plain lane-stacked
      sweep), window-A estimates pooled: the same-FLOPs baseline that
      separates "tempering helps mixing" from "C chains help averaging".

If the feasibility wall holds (span*accept trade-off), PT at practical C
is structurally unable to help this posterior and the result is recorded
as the sixth null in BASELINE.md; if the cold chain's tau/AUC beats the
controls beyond MC noise, tempering ships as a fit option instead.
Round-4 result (config5_pt.json; BASELINE.md config-5): feasible ladder
cut tau_int median 59 -> 9 and beat the single chain's matched-budget AUC
0.823 -> 0.860 — shipped as GLM.fit_tempered.

Run: python benchmarks/config5_pt.py [--N 500] [--T 20000] [--sweeps 2400]
     [--chains 8] [--out config5_pt.json]
"""
import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from config5_analysis import integrated_autocorr_time  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=500)
    ap.add_argument("--T", type=int, default=20_000)
    ap.add_argument("--sweeps", type=int, default=2400)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--span-lo", type=float, default=0.3)
    ap.add_argument("--accept-target", type=float, default=0.3)
    ap.add_argument("--precision", default="high")
    ap.add_argument("--out", default="config5_pt.json")
    ap.add_argument("--arms", default="control,span,feasible,ensemble",
                    help="comma-set of arms to run; skipped arms are "
                         "merged from --merge-from if given")
    ap.add_argument("--merge-from", default=None,
                    help="existing results JSON to carry skipped arms from")
    args = ap.parse_args()
    arms = set(args.arms.split(","))
    prev = {}
    if args.merge_from:
        with open(args.merge_from) as f:
            prev = json.load(f)

    import jax
    from pyglm_tpu.utils.utils import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import pyglm_tpu as pt
    from pyglm_tpu.models.tempering import (init_tempered_states,
                                            make_tempered_sweep,
                                            suggest_ladder)
    from pyglm_tpu.utils.metrics import link_auc

    N, T, S, C = args.N, args.T, args.sweeps, args.chains
    true = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=5, net_kwargs=dict(dim=2, mu_bias=-3.0))
    Y = true.generate(T, keep=False)
    true_A = true.A.copy()

    rng = np.random.RandomState(0)
    ii = jnp.asarray(rng.randint(0, N, size=64))
    jj = jnp.asarray(rng.randint(0, N, size=64))

    seg_len = 100
    assert S % seg_len == 0
    window = max(seg_len, (S // 8) // seg_len * seg_len)
    half = S // 2

    def panel(net_L, net_gamma):
        return net_gamma - jnp.sum((net_L[ii] - net_L[jj]) ** 2, axis=-1)

    def analyze(lrho_trace, auc_points, extra):
        taus = np.array([integrated_autocorr_time(lrho_trace[half:, k])
                         for k in range(64)])
        out = {"tau_int_median": float(np.median(taus)),
               "tau_int_p90": float(np.percentile(taus, 90)),
               "tau_int_max": float(np.max(taus)),
               "auc_trajectory": auc_points,
               "final_window_auc": auc_points[-1][1] if auc_points else None}
        out.update(extra)
        print(json.dumps(out), flush=True)
        return out

    # ---------------- control: single chain --------------------------------
    model = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=0, precision=args.precision,
        net_kwargs=dict(dim=2))
    model.add_data(Y)
    sweep1 = model._sweep
    datas = tuple(model.datas)

    @partial(jax.jit, static_argnames=("length",))
    def seg1(key, state, ds, length):
        def step(carry, k):
            s, acc = carry
            s, diag = sweep1(k, s, ds)
            return (s, acc + s.A), (panel(s.net.L, s.net.gamma),
                                    diag["log_likelihood"])
        (s, acc), (lrhos, lls) = jax.lax.scan(
            step, (state, jnp.zeros_like(state.A)),
            jax.random.split(key, length))
        return s, acc, lrhos, lls

    def run_control():
        state = model.state
        lrho_trace = np.zeros((S, 64), np.float32)
        ll_trace = np.zeros(S, np.float32)
        win_acc = np.zeros_like(true_A); win_n = 0
        pts = []
        t0 = time.time()
        for done in range(seg_len, S + 1, seg_len):
            state, acc, lrhos, lls = seg1(
                model._next_key(), state, datas, length=seg_len)
            lrho_trace[done - seg_len:done] = np.asarray(lrhos)
            ll_trace[done - seg_len:done] = np.asarray(lls)
            win_acc += np.asarray(acc); win_n += seg_len
            if win_n == window:
                pts.append([done, float(link_auc(win_acc / win_n, true_A))])
                win_acc[:] = 0.0; win_n = 0
        el = time.time() - t0
        sd_ll = float(np.std(ll_trace[half:]))
        return analyze(lrho_trace, pts,
                       {"arm": "control", "sd_ll_postburn": sd_ll,
                        "sweeps_per_sec": round(S / el, 2),
                        "seconds": round(el, 1)}), sd_ll

    if "control" in arms:
        print(f"# control ({S} sweeps)", flush=True)
        res_control, sd_ll = run_control()
    else:
        res_control = prev["control"]
        sd_ll = res_control["sd_ll_postburn"]

    # feasibility accounting
    from scipy.special import erfcinv
    dbeta_ok = 2.0 * erfcinv(args.accept_target) / sd_ll
    feas = {"sd_ll_postburn": sd_ll,
            "dbeta_for_accept": dbeta_ok,
            "rungs_to_span": int(np.ceil((1.0 - args.span_lo) / dbeta_ok)),
            "feasible_span_at_C": dbeta_ok * (C - 1)}
    print(json.dumps({"feasibility": feas}), flush=True)

    # ---------------- tempered arms ----------------------------------------
    def run_pt(label, betas):
        betas = np.asarray(betas, np.float64)
        m = pt.NonlinearAutoregressiveModel(
            N, B=4, L=10, observation="bernoulli", network="latent_distance",
            spike_and_slab=True, seed=0, precision=args.precision,
            net_kwargs=dict(dim=2))
        m.add_data(Y)
        sweepC = make_tempered_sweep(
            m.observation, m.network, N, m.B, betas, spike_slab=True,
            t_chunk=m._t_chunk, precision=args.precision)
        st = init_tempered_states(m, betas)
        ds = tuple(m.datas)
        cold = C - 1

        @partial(jax.jit, static_argnames=("length",))
        def segC(key, state, ds, length):
            # ds passed as an argument, not closed over: closures over big
            # arrays 413 the remote compile relay (CLAUDE.md gotcha).
            def step(carry, k):
                s, acc = carry
                s, diag = sweepC(k, s, ds)
                return ((s, acc + s.A[cold]),
                        (panel(s.net.L[cold], s.net.gamma[cold]),
                         diag["swap_accept"], diag["swap_parity"],
                         diag["log_likelihood"]))
            (s, acc), outs = jax.lax.scan(
                step, (state, jnp.zeros_like(true_A).astype(jnp.float32)),
                jax.random.split(key, length))
            return s, acc, outs

        key = jax.random.key(77)
        lrho_trace = np.zeros((S, 64), np.float32)
        sw_acc = np.zeros(C, np.float64)
        n_par1 = 0.0
        win_acc = np.zeros_like(true_A); win_n = 0
        pts = []
        t0 = time.time()
        for done in range(seg_len, S + 1, seg_len):
            key, k = jax.random.split(key)
            st, acc, (lrhos, sws, pars, lls) = segC(k, st, ds, length=seg_len)
            lrho_trace[done - seg_len:done] = np.asarray(lrhos)
            sw_acc += np.asarray(sws).sum(axis=0)
            n_par1 += float(np.asarray(pars).sum())
            win_acc += np.asarray(acc); win_n += seg_len
            if win_n == window:
                pts.append([done, float(link_auc(win_acc / win_n, true_A))])
                win_acc[:] = 0.0; win_n = 0
            if done % 400 == 0:
                el = time.time() - t0
                print(f"  {label}: {done}/{S} ({el:.0f}s, "
                      f"{done/el:.2f} sweeps/s)", flush=True)
        el = time.time() - t0
        # Per-ATTEMPT rates: interior rungs have a valid partner EVERY
        # sweep (only the two end rungs sit out the off parity —
        # models/tempering.py swap_permutation), so attempts are S for
        # interior rungs and the actual parity counts for the ends.
        # (The r4 run of this study normalized every rung by S/2, which
        # overstated interior per-attempt rates ~2x — VERDICT r4 weak #1.)
        n_par0 = S - n_par1
        attempts = np.full(C, float(S))
        attempts[0] = max(n_par0, 1.0)
        attempts[-1] = max(n_par0 if C % 2 == 0 else n_par1, 1.0)
        rung_rate = (sw_acc / attempts).tolist()
        return analyze(lrho_trace, pts, {
            "arm": label, "betas": betas.tolist(),
            "swap_rate_per_rung": [round(x, 4) for x in rung_rate],
            "swap_rate_mean": float(np.mean(rung_rate)),
            "sweeps_per_sec": round(S / el, 2), "seconds": round(el, 1)})

    # -------- ensemble control: C INDEPENDENT chains, pooled -------------
    # The feasible arm's cold lane borrows states from C-1 sibling rungs,
    # so the fair same-FLOPs baseline is C independent untempered chains
    # with their window-A estimates POOLED. Uses the plain lane-stacked
    # sweep (models/ensemble.py) — no swaps, so lane C-1's panel trace is
    # a true single chain (its tau should reproduce the control's) while
    # the pooled AUC shows what C-way averaging buys without tempering.
    def run_ensemble_control():
        from pyglm_tpu.models.ensemble import make_stacked_sweep
        m = pt.NonlinearAutoregressiveModel(
            N, B=4, L=10, observation="bernoulli", network="latent_distance",
            spike_and_slab=True, seed=0, precision=args.precision,
            net_kwargs=dict(dim=2))
        m.add_data(Y)
        sweepC = make_stacked_sweep(
            m.observation, m.network, N, m.B, C, spike_slab=True,
            t_chunk=m._t_chunk, precision=args.precision)
        st = init_tempered_states(m, np.ones(C))
        ds = tuple(m.datas)

        @partial(jax.jit, static_argnames=("length",))
        def segE(key, state, ds, length):
            def step(carry, k):
                s, acc, acc1 = carry
                s, diag = sweepC(k, s, ds)
                return ((s, acc + s.A.mean(axis=0), acc1 + s.A[C - 1]),
                        (panel(s.net.L[C - 1], s.net.gamma[C - 1]),
                         diag["log_likelihood"]))
            z = jnp.zeros_like(true_A).astype(jnp.float32)
            (s, acc, acc1), outs = jax.lax.scan(
                step, (state, z, z), jax.random.split(key, length))
            return s, acc, acc1, outs

        key = jax.random.key(99)
        lrho_trace = np.zeros((S, 64), np.float32)
        win_acc = np.zeros_like(true_A); win1 = np.zeros_like(true_A)
        win_n = 0
        pts, pts1 = [], []
        t0 = time.time()
        for done in range(seg_len, S + 1, seg_len):
            key, k = jax.random.split(key)
            st, acc, acc1, (lrhos, lls) = segE(k, st, ds, length=seg_len)
            lrho_trace[done - seg_len:done] = np.asarray(lrhos)
            win_acc += np.asarray(acc); win1 += np.asarray(acc1)
            win_n += seg_len
            if win_n == window:
                pts.append([done, float(link_auc(win_acc / win_n, true_A))])
                pts1.append([done, float(link_auc(win1 / win_n, true_A))])
                win_acc[:] = 0.0; win1[:] = 0.0; win_n = 0
            if done % 400 == 0:
                el = time.time() - t0
                print(f"  ensemble: {done}/{S} ({el:.0f}s)", flush=True)
        el = time.time() - t0
        # tau on ONE lane (the label-permuted cold lane is an exchangeable
        # mixture of the C chains — same marginal law as one chain)
        return analyze(lrho_trace, pts, {
            "arm": "ensemble", "auc_trajectory_single_lane": pts1,
            "sweeps_per_sec": round(S / el, 2), "seconds": round(el, 1)})

    if "span" in arms:
        print(f"# arm span ({C} rungs, beta {args.span_lo}..1)", flush=True)
        res_span = run_pt("span", np.geomspace(args.span_lo, 1.0, C))
    else:
        res_span = prev.get("span")

    if "feasible" in arms:
        betas_f, span_f = suggest_ladder(sd_ll, C, accept=args.accept_target)
        print(f"# arm feasible (dbeta={dbeta_ok:.5f}, span={span_f:.4f})",
              flush=True)
        res_feas = run_pt("feasible", betas_f)
    else:
        res_feas = prev.get("feasible")

    if "ensemble" in arms:
        print(f"# arm ensemble ({C} independent chains, pooled)", flush=True)
        res_ens = run_ensemble_control()
    else:
        res_ens = prev.get("ensemble")

    out = {"N": N, "T": T, "sweeps": S, "chains": C,
           "precision": args.precision, "feasibility": feas,
           "control": res_control, "span": res_span, "feasible": res_feas,
           "ensemble": res_ens}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
