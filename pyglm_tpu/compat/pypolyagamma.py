"""Drop-in API surface of the ``pypolyagamma`` package, on JAX devices.

Reference surface (pypolyagamma/pypolyagamma.pyx): a stateful
``PyPolyaGamma(seed)`` object with ``pgdraw``/``pgdrawv``, and module-level
``pgdrawvpar(ppgs, ns, zs, out)`` that fans a draw vector over OpenMP
threads. Here every method lowers to the same vectorized JAX samplers; the
"parallel" variant is identical to the serial one (the hardware is already
data-parallel) and accepts the list-of-generators argument purely for
API compatibility. `out` is filled in place (numpy) like the reference.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pyglm_tpu.ops.polyagamma import polya_gamma, pg_draw_unit


class PyPolyaGamma:
    """Stateful PG sampler handle (reference: PyPolyaGamma cdef class)."""

    def __init__(self, seed: int = 0):
        self._key = jax.random.key(int(seed) % (2 ** 31))

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def pgdraw(self, n, z) -> float:
        """Single PG(n, z) draw."""
        out = polya_gamma(self._next_key(),
                          jnp.asarray([float(n)]), jnp.asarray([float(z)]))
        return float(out[0])

    def pgdrawv(self, ns, zs, out=None):
        """Vector of PG(n_i, z_i) draws; fills `out` in place if given."""
        ns = jnp.asarray(np.asarray(ns, np.float32))
        zs = jnp.asarray(np.asarray(zs, np.float32))
        if bool(jnp.all(ns == 1.0)):
            res = np.asarray(pg_draw_unit(self._next_key(), zs))
        else:
            res = np.asarray(polya_gamma(self._next_key(), ns, zs))
        if out is not None:
            out[...] = res
            return out
        return res


def pgdrawv(ns, zs, out=None, seed: int = 0):
    return PyPolyaGamma(seed).pgdrawv(ns, zs, out)


def pgdrawvpar(ppgs, ns, zs, out=None):
    """Reference signature: list of per-thread PyPolyaGamma objects + draw
    vectors. The draw is already fully data-parallel on the device; like the
    reference's OpenMP static schedule, the vector is partitioned into
    contiguous chunks, one per generator, and each chunk consumes ITS
    generator's stream — so per-generator seed reproducibility matches the
    reference's per-thread behavior (same ppgs + same inputs => same
    chunk-to-stream assignment)."""
    if not len(ppgs):
        return PyPolyaGamma(0).pgdrawv(ns, zs, out)
    ns = np.asarray(ns, np.float32)
    zs = np.asarray(zs, np.float32)
    if len(ppgs) == 1 or ns.shape[0] == 0:
        return ppgs[0].pgdrawv(ns, zs, out)
    bounds = np.linspace(0, ns.shape[0], len(ppgs) + 1).astype(int)
    res = np.concatenate([
        np.atleast_1d(ppg.pgdrawv(ns[lo:hi], zs[lo:hi]))
        for ppg, lo, hi in zip(ppgs, bounds[:-1], bounds[1:])
        if hi > lo])
    if out is not None:
        out[...] = res
        return out
    return res
