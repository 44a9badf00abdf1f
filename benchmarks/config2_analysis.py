"""Config-2 (sparse NB, N=50) quality analysis — same protocol as
benchmarks/config5_analysis.py (VERDICT r1 task #9): truth-initialized
chain = identifiability ceiling; fresh chain = what the fitting sampler
reaches; if the gap is large the sampler (r-CRT mixing, PG b=y+r draws)
is suspect, if small the posterior is the ceiling.

Run: python benchmarks/config2_analysis.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from config5_analysis import chain_auc


def main():
    from pyglm_tpu.utils.utils import enable_compile_cache
    enable_compile_cache()
    import pyglm_tpu as pt

    N, T = 50, 20_000
    true = pt.SparseNegativeBinomialGLM(
        N, B=4, L=10, seed=2,
        obs_kwargs=dict(r_init=5.0, resample_r=False, max_y=256),
        net_kwargs=dict(rho_init=0.1, learn_rho=False))
    Y = true.generate(T, keep=False)
    true_A = true.A.copy()
    print(json.dumps({"N": N, "T": T, "rate": float(Y.mean()),
                      "true_density": float(true_A.mean())}))

    # A. truth-initialized ceiling.
    true.add_data(Y)
    t0 = time.time()
    res_a = chain_auc(true, true_A, n_burn=30, n_avg=100,
                      label="truth_init_ceiling")
    print(f"phase A: {time.time()-t0:.0f}s")

    # B. fresh chain (the acceptance protocol, longer).
    model = pt.SparseNegativeBinomialGLM(
        N, B=4, L=10, seed=0, obs_kwargs=dict(max_y=256))
    model.add_data(Y)
    t0 = time.time()
    res_b = chain_auc(model, true_A, n_burn=400, n_avg=100,
                      label="fresh_long")
    print(f"phase B: {time.time()-t0:.0f}s")

    with open("config2_analysis.json", "w") as f:
        json.dump({"N": N, "T": T, "truth_init": res_a, "fresh": res_b}, f,
                  indent=1)


if __name__ == "__main__":
    main()
