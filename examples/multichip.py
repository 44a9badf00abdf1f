"""Demo: neuron+time-sharded SPMD Gibbs over a device mesh (BASELINE
config 5: latent-distance prior, N=500, multi-chip).

On a machine with one device, simulate devices first:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/multichip.py
(with jax platform forced to cpu; on a multi-GPU host it runs as-is).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # zero-install run

import jax
import numpy as np

import pyglm_tpu as pt
from pyglm_tpu.parallel.sharding import best_mesh_for

N = 500
print(f"devices: {jax.devices()}")

true = pt.NonlinearAutoregressiveModel(
    N, B=4, L=10, observation="bernoulli", network="latent_distance",
    spike_and_slab=True, seed=11,
    net_kwargs=dict(dim=2, mu_bias=-3.0))
Y = true.generate(10_000, keep=False)
print(f"rate={Y.mean():.3f}")

N_SWEEPS = 25


def run(shard: bool):
    model = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=0, net_kwargs=dict(dim=2))
    model.add_data(Y)
    if shard:
        mesh = best_mesh_for(N, T=[10_000])
        print(f"mesh: {dict(mesh.shape)}")
        model.shard(mesh)
    lls, dens = [], []
    for it in range(N_SWEEPS):
        d = model.resample_model()
        lls.append(float(d["log_likelihood"]))
        dens.append(float(d["n_edges"]) / (N * N))
        if it % 5 == 0:
            print(f"{'sharded' if shard else 'unsharded'} iter {it}: "
                  f"ll={lls[-1]:.0f} edges={d['n_edges']:.0f}")
    return np.array(lls), np.array(dens)


ll_s, dens_s = run(shard=True)

# --- figures: sharded vs unsharded trace overlay (VERDICT r4 next #8) -----
# The sharded sweep is the SAME Gibbs kernel distributed over the mesh
# (different RNG partitioning, so traces agree statistically, not
# bitwise); the overlay makes the equivalence visible.
try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:
    print("matplotlib unavailable; skipping figures")
    sys.exit(0)

ll_u, dens_u = run(shard=False)

fig, axes = plt.subplots(1, 2, figsize=(11, 4))
axes[0].plot(ll_u, "k-", lw=1.2, label="unsharded")
axes[0].plot(ll_s, "r--", lw=1.2, label=f"sharded ({len(jax.devices())} dev)")
axes[0].set_title("log-likelihood trace")
axes[0].set_xlabel("sweep")
axes[0].legend()
axes[1].plot(dens_u, "k-", lw=1.2, label="unsharded")
axes[1].plot(dens_s, "r--", lw=1.2, label="sharded")
axes[1].set_title("edge density trace")
axes[1].set_xlabel("sweep")
axes[1].legend()
out_png = os.path.join(os.path.dirname(__file__), "multichip.png")
fig.savefig(out_png, dpi=120, bbox_inches="tight")
print(f"wrote {out_png}")
