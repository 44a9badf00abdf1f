"""Tracing / profiling helpers (SURVEY.md §5: absent in the reference).

- ``phase``: context manager that wall-clocks a named phase, ending with
  ``jax.block_until_ready`` on the phase's output.
- ``sweep_breakdown``: times each stage of a Gibbs sweep for a model at its
  registered data shapes, at the model's own precision.
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

import jax
import jax.numpy as jnp


class PhaseTimer:
    def __init__(self):
        self.times = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if "out" in box:
                jax.block_until_ready(box["out"])
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'phase':24s} {'ms':>9s} {'%':>6s}"]
        for k, v in self.times.items():
            lines.append(f"{k:24s} {v * 1e3:9.1f} {100 * v / total:6.1f}")
        lines.append(f"{'TOTAL':24s} {total * 1e3:9.1f}")
        return "\n".join(lines)


def sweep_breakdown(model, n_reps: int = 3) -> OrderedDict:
    """Per-stage timings of one Gibbs sweep at the model's data shapes.

    Stages: psi matmul, PG draws, group Gram blocks, the collapsed
    spike-and-slab update (its residual gathers/scatters and edge scan,
    with the Gram blocks of the previous stage passed in), network
    resample, observation aux (the NB dispersion's CRT update). Each stage
    runs as its own compiled program at the model's precision. Returns
    OrderedDict[name -> seconds].
    """
    from pyglm_tpu.models.weights import (
        einsum_at, pack_weights, group_gram_blocks,
        resample_spike_slab_tspace, _auto_group)

    assert model.datas, "add data first"
    Xf = jnp.concatenate([d.Xf for d in model.datas], axis=0)
    Xt = jnp.concatenate([d.Xt for d in model.datas], axis=1)
    Y = jnp.concatenate([d.Y for d in model.datas], axis=0)
    state = model.state
    w_full = pack_weights(state.A, state.W, state.b)
    hyp = model.network.edge_hypers(state.net)
    key = jax.random.key(0)
    B, prec = model.B, model._precision
    G = _auto_group((model.P - 1) // B, B)

    pt = PhaseTimer()
    psi_f = jax.jit(lambda X, w: einsum_at("tp,pn->tn", X, w, prec))
    pg_f = jax.jit(lambda k, Yv, p: model.observation.omega_kappa(
        k, Yv, p, state.aux))
    gram_f = jax.jit(lambda X, om: group_gram_blocks(
        X, om, B, G, t_chunk=model._t_chunk, precision=prec))
    ss_f = jax.jit(lambda k, X, Xt_, om, ka, w, hy, ps, Jg:
                   resample_spike_slab_tspace(
                       k, X, om, ka, w, hy, B, t_chunk=model._t_chunk,
                       precision=prec, group=G, psi=ps, Jg=Jg, Xt=Xt_))
    net_f = jax.jit(lambda k, A, W: model.network.resample(k, state.net, A, W))
    llc = model.datas[0].llc if len(model.datas) == 1 else None
    aux_f = jax.jit(lambda k, Yv, p: model.observation.resample_aux(
        k, state.aux, Yv, p, cache=llc))

    # warmup (compiles every stage)
    psi = jax.block_until_ready(psi_f(Xf, w_full))
    omega, kappa = jax.block_until_ready(pg_f(key, Y, psi))
    Jg = jax.block_until_ready(gram_f(Xf, omega))
    if model.spike_and_slab:
        jax.block_until_ready(ss_f(key, Xf, Xt, omega, kappa, w_full, hyp, psi, Jg))
    jax.block_until_ready(aux_f(key, Y, psi))
    jax.block_until_ready(net_f(key, state.A, state.W))

    for _ in range(n_reps):
        with pt.phase("psi_matmul") as box:
            box["out"] = psi_f(Xf, w_full)
        with pt.phase("pg_draws") as box:
            omega, kappa = pg_f(key, Y, psi)
            box["out"] = omega
        with pt.phase("group_gram") as box:
            box["out"] = gram_f(Xf, omega)
        if model.spike_and_slab:
            with pt.phase("spike_slab_scan") as box:
                box["out"] = ss_f(key, Xf, Xt, omega, kappa, w_full, hyp,
                                  psi, Jg)
        with pt.phase("obs_aux") as box:
            box["out"] = aux_f(key, Y, psi)
        with pt.phase("network_resample") as box:
            box["out"] = net_f(key, state.A, state.W)

    return OrderedDict((k, v / n_reps) for k, v in pt.times.items())
