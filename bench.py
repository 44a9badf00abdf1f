"""Headline benchmark: Gibbs sweeps/sec on the flagship config.

Config (BASELINE.json metric): sparse Bernoulli network GLM, Erdős–Rényi
spike-and-slab, N=200 neurons, T=100k bins, B=4 basis filters — one full
Gibbs sweep = PG draws for all 20M auxiliaries + X'OmegaX stats for all
neurons + collapsed spike-and-slab over all 40k edges + network hypers.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"value_fast", "vs_baseline_fast", "device"} — `value` is the
LIBRARY-DEFAULT precision ("high": f32-grade, three bf16 products per
f32 dot); `value_fast` is precision="default" (TF32 on an H100);
`device` names the platform, device kind and count it ran on.

Exits non-zero unless JAX's default device is a GPU; ``--small`` (N=20,
T=5k) is a quick self-check that runs on any platform.

vs_baseline denominator: 0.002254 sweeps/s — the architecture-faithful
NumPy/f64 re-implementation (pyglm_tpu/reference/numpy_ref.py) at N=200,
measured on a host CPU at T in {1k, 3k} and fitted linearly (sweep = 4.3 s
+ 4.39 s per 1k bins -> 444 s at T=100k). Check points at T=10k (82.5 s)
and T=20k (199.2 s) show the true cost is SUPER-linear beyond the fitted
range, so 444 s at T=100k is a LOWER bound on the CPU cost and the
reported vs_baseline is conservative. The true reference
(slinderman/pyglm) is unbuildable here (SURVEY.md provenance note); the
stand-in mirrors its per-neuron loop architecture.
"""
import json
import sys
import time

import numpy as np

CPU_BASELINE_SWEEPS_PER_SEC = 0.002254

N, T, B, L = 200, 100_000, 4, 10
# Sweeps scanned per timed launch; the timing ends in block_until_ready.
N_WARMUP, N_TIMED = 2, 50


def main():
    import jax
    small = "--small" in sys.argv          # quick self-check mode
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not small:
        print(f"bench.py: needs a GPU, JAX found {dev.platform!r} "
              f"(use --small for a self-check)", file=sys.stderr)
        sys.exit(2)
    import pyglm_tpu as pt
    from benchmarks.common import bernoulli_flagship_data
    from pyglm_tpu.utils.utils import enable_compile_cache
    enable_compile_cache()

    n, t = (20, 5_000) if small else (N, T)
    Y = bernoulli_flagship_data(pt, n, t, B=B, L=L)

    def measure(precision):
        # Time the chain the way the library runs chains: sweeps scanned on
        # device (fit_compiled's shape), so per-sweep host dispatch is not
        # billed to the sampler. datas is an ARGUMENT, not a closure, so the
        # design tensor is not baked into the program as a constant.
        model = pt.SparseBernoulliGLM(n, B=B, L=L, seed=0,
                                      precision=precision)
        model.add_data(Y)
        sweep = model._sweep

        @jax.jit
        def run_k(key, state, datas):
            def body(s, kk):
                s, d = sweep(kk, s, datas)
                return s, d["log_likelihood"]
            return jax.lax.scan(body, state, jax.random.split(key, N_TIMED))

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

    value = measure("high")
    value_fast = measure("default")
    print(json.dumps({
        "metric": f"gibbs_sweeps_per_sec_N{n}_T{t}_B{B}",
        "value": round(value, 4),
        "unit": "sweeps/s",
        "vs_baseline": round(value / CPU_BASELINE_SWEEPS_PER_SEC, 1),
        "value_fast": round(value_fast, 4),
        "vs_baseline_fast": round(value_fast / CPU_BASELINE_SWEEPS_PER_SEC,
                                  1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
