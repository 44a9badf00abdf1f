"""Per-stage times of one Gibbs sweep at the flagship shapes.

Runs diagnostics.profiling.sweep_breakdown (each stage as its own compiled
program, timed to block_until_ready) for the sparse Bernoulli flagship at
precision "high", "default" and "highest" and for the negative-binomial
flagship at "high" (N=200, T=100k, B=4), and prints one JSON line per cell
with the stage times in milliseconds, the device, and the card's name and
power limit.

Run: python benchmarks/stage_times.py
Exits non-zero unless JAX's default device is a GPU.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N, T, B, L = 200, 100_000, 4, 10


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"stage_times.py: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        sys.exit(2)
    import jax.numpy as jnp
    import pyglm_tpu as pt
    from pyglm_tpu.diagnostics.profiling import sweep_breakdown
    from pyglm_tpu.utils.utils import enable_compile_cache
    from common import bernoulli_flagship_data, nb_flagship_models
    enable_compile_cache()

    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card()}

    Y = bernoulli_flagship_data(pt, N, T, B=B, L=L)
    _, fresh_nb, Y_nb = nb_flagship_models(pt, jnp, N, T, B=B, L=L)
    cells = [("bernoulli", "high"), ("bernoulli", "default"),
             ("bernoulli", "highest"), ("negative_binomial", "high")]
    for obs, prec in cells:
        if obs == "bernoulli":
            model = pt.SparseBernoulliGLM(N, B=B, L=L, seed=0,
                                          precision=prec)
            model.add_data(Y)
        else:
            model = fresh_nb(prec)
            model.add_data(Y_nb)
        times = sweep_breakdown(model, n_reps=5)
        print(json.dumps({
            "cell": f"{obs}_N{N}_T{T}_B{B}", "precision": prec,
            "stage_ms": {k: v * 1e3 for k, v in times.items()},
            "device": device}), flush=True)


if __name__ == "__main__":
    main()
