"""Offline KS study: gamma-series truncation K vs the exact native
oracle (integer b) and vs K=128 (fractional b). Supported the K=16 -> 8
kernel-cost reduction for the NB path (r3) and the 8 -> 4 trim enabled by
the 3-moment shifted-gamma tail (r4).

Run on CPU: python benchmarks/k8_study.py [--K 4,8]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
from scipy.stats import ks_2samp

from pyglm_tpu.ops.polyagamma import pg_gamma_series
from pyglm_tpu.utils.utils import enable_compile_cache

enable_compile_cache()
from pyglm_tpu.native import native_available, pg_int_b_native

N = 200_000


def ks(x, y):
    return ks_2samp(np.asarray(x), np.asarray(y)).statistic


def main():
    import math
    import time

    ap = argparse.ArgumentParser()
    ap.add_argument("--K", default="8,16",
                    help="comma list of truncation levels to test")
    args = ap.parse_args()
    Ks = tuple(int(k) for k in args.K.split(","))

    assert native_available()
    # Two-sample KS threshold at alpha=1e-4, n=m=200k.
    thr = math.sqrt(-0.5 * math.log(1e-4 / 2.0)) * math.sqrt(2.0 / N)
    print(f"alpha=1e-4 threshold at n={N}: {thr:.5f}", flush=True)
    key = jax.random.key(0)
    worst = {}

    def row(b, c, K, d):
        flag = "  FAIL" if d > thr else ""
        print(f"b={b:>6} c={c:>4} K={K:>3}: KS={d:.5f}{flag}", flush=True)
        worst[K] = max(worst.get(K, 0.0), d)

    # Integer b: exact oracle comparison.
    for b in [1, 2, 3, 5, 13, 20, 40, 80, 130]:
        for c in [0.0, 1.5, 6.0, 30.0]:
            t0 = time.time()
            nat = pg_int_b_native(
                np.full(N, float(b)), np.full(N, float(c)), seed=b * 100 + 7)
            t_nat = time.time() - t0
            t_ours = {}
            for K in Ks:
                key, k2 = jax.random.split(key)
                t0 = time.time()
                ours = jax.block_until_ready(pg_gamma_series(
                    k2, jnp.full((N,), float(b)), jnp.full((N,), float(c)),
                    K=K))
                t_ours[K] = time.time() - t0
                row(b, c, K, ks(ours, nat))
            tstr = " / ".join(f"K{K} {t_ours[K]:.1f}s" for K in Ks)
            print(f"    [native {t_nat:.1f}s, series {tstr}]", flush=True)
    # Fractional b: K vs K=128 self-comparison.
    for b in [0.3, 0.7, 1.5, 4.2]:
        for c in [0.0, 1.5, 6.0]:
            key, kref = jax.random.split(key)
            ref = pg_gamma_series(
                kref, jnp.full((N,), b), jnp.full((N,), c), K=128)
            for K in Ks:
                key, k2 = jax.random.split(key)
                ours = pg_gamma_series(
                    k2, jnp.full((N,), b), jnp.full((N,), c), K=K)
                row(b, c, K, ks(ours, ref))

    print({f"worst_K{K}": round(v, 5) for K, v in worst.items()}, flush=True)


if __name__ == "__main__":
    main()
