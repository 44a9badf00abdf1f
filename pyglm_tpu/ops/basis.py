"""Raised-cosine temporal basis and causal spike-history convolution.

Capability parity with ``pyglm/utils/basis.py`` (``cosine_basis``,
``convolve_with_basis``), rebuilt for an accelerator: the design tensor is
formed by a single XLA convolution (``lax.conv_general_dilated``) over the
whole spike matrix instead of per-column scipy ``fftconvolve`` calls.

Conventions (matching the reference's causal one-bin shift):
    X[t, n, b] = sum_{d=1..L} Y[t-d, n] * basis[d-1, b]
so the design row at time t only sees spikes strictly before t.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def cosine_basis(B: int, L: int, orth: bool = False, norm: bool = True,
                 offset: float = 1.0) -> np.ndarray:
    """Raised-cosine basis (Pillow-style log-time warping).

    B filters over L bins: peaks are spaced linearly in warped time
    w(t) = log(t + offset), each filter is half a cosine bump of width
    2x the peak spacing, clipped to zero outside.

    Args:
      B: number of basis filters.
      L: filter length in bins.
      orth: orthonormalize the columns (QR).
      norm: L1-normalize each column (so a single spike contributes unit
        total mass through each filter).
      offset: warp offset c in w(t) = log(t + c); larger = more linear.

    Returns:
      (L, B) float32 numpy array (host constant — precomputed once).
    """
    assert B >= 1 and L >= 1
    t = np.arange(L, dtype=np.float64)
    w = np.log(t + offset)
    lo, hi = w[0], w[-1]
    if B == 1:
        peaks = np.array([(lo + hi) / 2.0])
        dw = max(hi - lo, 1.0) / 2.0
    else:
        peaks = np.linspace(lo, hi, B)
        dw = peaks[1] - peaks[0]
    arg = np.clip((w[:, None] - peaks[None, :]) * np.pi / (2.0 * dw), -np.pi, np.pi)
    basis = 0.5 * (1.0 + np.cos(arg))

    if norm:
        basis = basis / np.maximum(basis.sum(axis=0, keepdims=True), 1e-12)
    if orth:
        q, r = np.linalg.qr(basis)
        # Fix signs so each column has positive peak.
        signs = np.sign(q[np.argmax(np.abs(q), axis=0), np.arange(B)])
        basis = q * signs[None, :]
    return basis.astype(np.float32)


def convolve_with_basis(Y: jax.Array, basis) -> jax.Array:
    """Causal convolution of a spike matrix with a temporal basis.

    Args:
      Y: (T, N) spike counts (any numeric dtype).
      basis: (L, B) filters.

    Returns:
      (T, N, B) float32 design tensor with
      X[t, n, b] = sum_{d=1..L} Y[t-d, n] * basis[d-1, b]
      (zero-padded before t=0).

    Reference analog: pyglm/utils/basis.py (convolve_with_basis) — scipy
    fftconvolve per basis column + one-bin shift. Here: one grouped XLA conv.
    """
    basis = jnp.asarray(basis, dtype=jnp.float32)
    L, B = basis.shape
    T, N = Y.shape
    # lhs: (batch=N, chan=1, time=T); rhs: (out=B, in=1, width=L).
    lhs = Y.T.astype(jnp.float32)[:, None, :]
    # XLA conv is cross-correlation; our causal sum needs the reversed filter
    # with left padding L (derivation in module docstring/tests).
    rhs = basis[::-1].T[:, None, :]
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding=[(L, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        # Full f32 (no TF32 / bf16 input truncation): the design tensor is
        # "the data" — it must match the host-side oracle to f32 accuracy.
        precision=lax.Precision.HIGHEST,
    )  # (N, B, T+1)
    return out[:, :, :T].transpose(2, 0, 1)


def design_matrix_sharded(Y: jax.Array, basis, mesh,
                          with_bias: bool = True) -> jax.Array:
    """Time-sharded design ingest: build Xf under the ('time','neuron') mesh
    without ever materializing the full (T, P) design on one device
    (SURVEY.md §5 long-context row; VERDICT r2 missing #2).

    Each time shard owns T/n_time spike rows; the causal convolution needs
    the L bins preceding each shard, which are exchanged with one
    ``lax.ppermute`` from the previous shard (the first shard's halo is the
    ppermute fill value 0 — exactly the global zero-padding before t=0).
    The local conv then runs on [halo; Y_local] and drops its first L rows,
    which is bit-identical to the corresponding global rows (each output
    row is the same dot product of the same L inputs).

    Returns Xf (T, N*B [+1]) sharded PartitionSpec('time', None).
    """
    from jax.sharding import PartitionSpec as PS

    basis = jnp.asarray(basis, dtype=jnp.float32)
    L = basis.shape[0]
    n_time = mesh.shape.get("time", 1)
    T = Y.shape[0]
    assert T % n_time == 0, (T, n_time)
    assert T // n_time >= L, (
        f"time shards of {T // n_time} bins are shorter than the basis "
        f"filter (L={L}); use fewer time shards")

    def fn(y):
        halo = lax.ppermute(y[-L:], "time",
                            [(i, i + 1) for i in range(n_time - 1)])
        yc = jnp.concatenate([halo, y], axis=0)
        return design_matrix(yc, basis, with_bias=with_bias)[L:]

    return jax.shard_map(
        fn, mesh=mesh, in_specs=PS("time", None),
        out_specs=PS("time", None), check_vma=False)(Y)


def design_matrix(Y: jax.Array, basis, with_bias: bool = True) -> jax.Array:
    """Flattened design matrix Xf = (T, N*B [+1]) with optional ones column.

    Column ordering: presynaptic neuron-major, basis-minor —
    Xf[:, j*B + b] = X[:, j, b]; final column (if with_bias) is all-ones.
    This is the layout every downstream sufficient-statistic matmul assumes.
    """
    X = convolve_with_basis(Y, basis)
    T, N, B = X.shape
    Xf = X.reshape(T, N * B)
    if with_bias:
        Xf = jnp.concatenate([Xf, jnp.ones((T, 1), dtype=Xf.dtype)], axis=1)
    return Xf
