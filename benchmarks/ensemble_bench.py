"""Ensemble throughput: sequential chains vs the lane-stacked sweep.

Measures aggregate chain-sweeps/sec for a C-chain ensemble at the
BASELINE config-1 scale (N=27, T=60k — a small model whose per-edge steps
leave the device mostly idle, the regime the lane-stacked design targets)
and at a mid-size N=100. Methodology as bench.py: scanned sweeps inside
one jit, timed to block_until_ready, datas as arguments.

Run on a GPU: python benchmarks/ensemble_bench.py [--small]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

C = 8
N_WARMUP, N_TIMED = 2, 30


def main():
    import jax
    from pyglm_tpu.utils.utils import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    import pyglm_tpu as pt
    from pyglm_tpu.models.ensemble import make_stacked_sweep, stack_states
    from pyglm_tpu.models.sweep import init_state_from_prior

    small = "--small" in sys.argv
    shapes = [(20, 3_000)] if small else [(27, 60_000), (100, 60_000)]
    out = {"metric": "ensemble_chain_sweeps_per_sec", "unit": "sweeps/s",
           "chains": C}

    for N, T in shapes:
        true = pt.SparseBernoulliGLM(
            N, B=4, L=10, seed=42,
            net_kwargs=dict(rho_init=0.2, learn_rho=False, mu_bias=-2.5,
                            sigma_bias=0.25, learn_weight_prior=False,
                            sigma_w=1.0))
        Y = true.generate(T, keep=False)
        m = pt.SparseBernoulliGLM(N, B=4, L=10, seed=0)
        m.add_data(Y)
        datas = tuple(m.datas)

        def timed(run, state):
            for i in range(N_WARMUP):
                state, lls = jax.block_until_ready(
                    run(jax.random.key(i), state, datas))
            reps = []
            for i in range(3):
                t0 = time.perf_counter()
                state, lls = jax.block_until_ready(
                    run(jax.random.key(50 + i), state, datas))
                reps.append((time.perf_counter() - t0) / N_TIMED)
            return float(np.median(reps))

        # -- sequential baseline: one chain on the model's sweep ----------
        sweep1 = m._sweep

        @jax.jit
        def run1(key, state, datas):
            def body(s, kk):
                s, d = sweep1(kk, s, datas)
                return s, d["log_likelihood"]
            return jax.lax.scan(body, state,
                               jax.random.split(key, N_TIMED))

        t1 = timed(run1, m.state)

        # -- lane-stacked: C chains in one sweep --------------------------
        sweepC = make_stacked_sweep(
            m.observation, m.network, N, m.B, C, m.spike_and_slab,
            t_chunk=m._t_chunk, precision=m._precision)
        keys = jax.random.split(jax.random.key(7), C)
        stC = stack_states([
            init_state_from_prior(k, m.observation, m.network, N, m.B,
                                  m.spike_and_slab) for k in keys])

        @jax.jit
        def runC(key, state, datas):
            def body(s, kk):
                s, d = sweepC(kk, s, datas)
                return s, d["log_likelihood"]
            return jax.lax.scan(body, state,
                               jax.random.split(key, N_TIMED))

        tC = timed(runC, stC)

        key_s = f"N{N}_T{T}"
        out[key_s] = {
            "sequential_chain_sweeps_per_sec": round(C / (C * t1), 2),
            "sequential_ensemble_sec_per_sweep_x8": round(C * t1 * 1e3, 2),
            "stacked_ensemble_sec_per_sweep_x8": round(tC * 1e3, 2),
            "aggregate_sequential": round(1.0 / t1, 2),
            "aggregate_stacked": round(C / tC, 2),
            "speedup": round(C / tC * t1, 2),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
