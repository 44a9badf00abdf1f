"""Demo: exact chain checkpoint/resume.

MCMC state is an explicit pytree, so checkpointing is exact: saving and
reloading resumes the SAME chain (identical PRNG stream), unlike the
reference's pickle-by-convention approach.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # zero-install run

import numpy as np

import pyglm_tpu as pt
from pyglm_tpu.utils.checkpoint import save_state, load_state

model = pt.SparseBernoulliGLM(10, B=4, L=10, seed=0)
Y = model.generate(5000, keep=True)
for _ in range(20):
    model.resample_model()

path = os.path.join(tempfile.gettempdir(), "pyglm_chain.npz")
save_state(path, model)
print(f"saved chain state to {path}")

# ... later / elsewhere: rebuild the same config and resume
resumed = pt.SparseBernoulliGLM(10, B=4, L=10, seed=999)  # seed irrelevant
resumed.add_data(Y)
load_state(path, resumed)

lls1, lls2 = [], []
for _ in range(15):
    lls1.append(float(model.resample_model()["log_likelihood"]))
    lls2.append(float(resumed.resample_model()["log_likelihood"]))
print(f"continued:  ll={lls1[0]:.3f}")
print(f"resumed:    ll={lls2[0]:.3f}")
assert lls1 == lls2, "chains diverged!"
print("exact resume verified (identical trajectories)")

# --- figure: the two trajectories coincide EXACTLY after the resume ------
try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:
    print("matplotlib unavailable; skipping figure")
    sys.exit(0)

fig, ax = plt.subplots(figsize=(7, 4))
ax.plot(np.arange(len(lls1)), lls1, "k-", lw=2, label="original chain")
ax.plot(np.arange(len(lls2)), lls2, "r--", lw=1.2,
        label="resumed from checkpoint")
ax.axvline(0, color="0.6", ls=":", lw=1)
ax.annotate("checkpoint", xy=(0, min(lls1)), xytext=(1.2, min(lls1)),
            color="0.4")
ax.set_title("exact resume: identical PRNG stream, identical trajectory")
ax.set_xlabel("sweep after checkpoint")
ax.set_ylabel("log-likelihood")
ax.legend()
out_png = os.path.join(os.path.dirname(__file__), "checkpoint_resume.png")
fig.savefig(out_png, dpi=120, bbox_inches="tight")
print(f"wrote {out_png}")
