"""NB-flagship throughput: Gibbs sweeps/sec for the negative-binomial GLM
at the flagship shapes (N=200, T=100k, B=4) — the config whose hot loop is
the gamma-series PG sampler (b = y + r is non-integer), not Devroye.

Methodology matches bench.py exactly: sweeps scanned on device inside one
jit, timed to block_until_ready over N_TIMED iterations, datas passed as
arguments.

Run on a GPU: python benchmarks/nb_bench.py [--small]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N, T, B, L = 200, 100_000, 4, 10
N_WARMUP, N_TIMED = 2, 50


def main():
    import jax
    from pyglm_tpu.utils.utils import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from jax import lax
    import numpy as np
    import pyglm_tpu as pt

    from common import nb_flagship_models

    small = "--small" in sys.argv
    n, t = (20, 5_000) if small else (N, T)

    true, fresh, Y = nb_flagship_models(pt, jnp, n, t, B=B, L=L)

    def measure(precision):
        model = fresh(precision)
        model.add_data(Y)
        sweep = model._sweep

        @jax.jit
        def run_k(key, state, datas):
            def body(s, kk):
                s, d = sweep(kk, s, datas)
                return s, d["log_likelihood"]
            return lax.scan(body, state, jax.random.split(key, N_TIMED))

        datas = tuple(model.datas)
        state = model.state
        for i in range(N_WARMUP):
            state, lls = jax.block_until_ready(
                run_k(jax.random.key(i), state, datas))
        reps = []
        for i in range(3):
            t0 = time.perf_counter()
            state, lls = jax.block_until_ready(
                run_k(jax.random.key(100 + i), state, datas))
            reps.append((time.perf_counter() - t0) / N_TIMED)
        assert np.all(np.isfinite(np.asarray(lls)))
        return 1.0 / float(np.median(reps))

    high = measure("high")
    fast = measure("default")
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "nb_flagship_sweeps_per_sec",
        "value": round(high, 2), "unit": "sweeps/s",
        "value_fast": round(fast, 2),
        "shapes": {"N": n, "T": t, "B": B},
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }))


if __name__ == "__main__":
    main()
