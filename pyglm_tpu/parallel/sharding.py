"""Multi-device scaling via jax.sharding — the reference has no analog.

The reference's only parallelism is OpenMP threads over PG draws inside one
process (pypolyagamma.pyx pgdrawvpar). Here the Gibbs sweep is partitioned
over a 2-D device mesh (SURVEY.md §2.4 / §7 step 8):

- **neuron axis**: per-neuron conditionals are independent given the data,
  so omega/kappa columns, the (N, P, P) sufficient-statistic stack, and the
  vmapped weight updates shard embarrassingly over postsynaptic neurons.
- **time axis**: X'OmegaX / X'kappa / log-lik are associative sums over t,
  so time shards reduce partial stats with XLA-inserted collectives over
  the device interconnect (the SP analog — nothing here is quadratic in T).

Everything goes through GSPMD: inputs carry NamedShardings and XLA chooses
the collectives; no hand-written NCCL/MPI-style code (SURVEY.md §2.4).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyglm_tpu.models.sweep import GLMData, GLMState


# --- active-mesh context -----------------------------------------------------
# The samplers and the collapsed spike-and-slab update run as explicit
# per-shard passes (jax.shard_map) under a mesh, so their call sites
# (ops/polyagamma.py, models/weights.py) consult the active mesh at trace
# time and wrap themselves in a shard_map over it.
_ACTIVE_MESH: Mesh | None = None


def set_active_mesh(mesh: Mesh | None) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH


def make_mesh(n_time: int = 1, n_neuron: int | None = None, devices=None) -> Mesh:
    """Create a ('time', 'neuron') mesh. Defaults to all devices on the
    neuron axis (the embarrassingly-parallel one)."""
    if devices is None:
        devices = jax.devices()
    if n_neuron is None:
        n_neuron = len(devices) // n_time
    assert n_time * n_neuron == len(devices), (
        f"mesh {n_time}x{n_neuron} != {len(devices)} devices")
    dev_array = np.asarray(devices).reshape(n_time, n_neuron)
    return Mesh(dev_array, axis_names=("time", "neuron"))


def make_chain_mesh(n_chains: int | None = None, devices=None) -> Mesh:
    """Create a 1-D ('chain',) mesh for chain-axis data parallelism —
    independent MCMC chains (fit_ensemble) or tempering rungs
    (fit_tempered) spread one-per-device group, with the dataset
    replicated. The embarrassingly-parallel MCMC axis: the Gibbs pass
    needs ZERO collectives (models/ensemble.py)."""
    if devices is None:
        devices = jax.devices()
    if n_chains is None:
        n_chains = len(devices)
    assert len(devices) >= n_chains > 0, (n_chains, len(devices))
    return Mesh(np.asarray(devices[:n_chains]), axis_names=("chain",))


def make_chain_data_mesh(n_chain: int, n_time: int = 1,
                         n_neuron: int | None = None, devices=None) -> Mesh:
    """Create a 3-D ('chain', 'time', 'neuron') mesh composing chain-axis
    parallelism with the data-parallel axes: C chains (or tempering rungs)
    spread over `n_chain` device groups, each group running the
    time/neuron-sharded sweep over its ('time', 'neuron') sub-grid.

    This is the config-5 multi-chip story (an N=500 neuron/time-sharded
    model) combined with the round-4 ladder/ensemble machinery: pass the
    mesh to ``fit_ensemble(mesh=...)`` / ``fit_tempered(mesh=...)`` —
    those paths stack chains on postsynaptic lanes (models/ensemble.py),
    so the lane axis shards jointly over ('chain', 'neuron') while the
    sufficient-statistic reductions psum over 'time' (the lane kernels
    are chain-agnostic: a lane is a lane). Requires C divisible by
    n_chain, N by n_neuron, and T by n_time."""
    if devices is None:
        devices = jax.devices()
    if n_neuron is None:
        n_neuron = len(devices) // (n_chain * n_time)
    n = n_chain * n_time * n_neuron
    assert 0 < n <= len(devices), (n_chain, n_time, n_neuron, len(devices))
    dev_array = np.asarray(devices[:n]).reshape(n_chain, n_time, n_neuron)
    return Mesh(dev_array, axis_names=("chain", "time", "neuron"))


def lane_axes(mesh: Mesh) -> tuple:
    """Mesh axes that shard the POSTSYN-LANE dimension of the sweep's
    (T, lanes) arrays, major -> minor. On a ('time','neuron') mesh lanes
    are neurons; on a ('chain','time','neuron') mesh the lane axis is the
    chain-major C*N stack (models/ensemble.py _to_lanes), so it shards
    jointly over ('chain','neuron') — PartitionSpec tuple entries split
    an array axis over several mesh axes in exactly that major/minor
    order. The lane kernels (PG draws, Gram blocks, the fused
    spike-and-slab pass) are lane-agnostic, so a device's lane block may
    even straddle two chains; only the per-chain reductions (network
    resample, swap moves) care, and those run outside the lane kernels."""
    return tuple(a for a in ("chain", "neuron") if a in mesh.shape)


def lane_count(mesh: Mesh) -> int:
    """Total number of devices sharding the postsyn-lane axis."""
    n = 1
    for a in lane_axes(mesh):
        n *= mesh.shape[a]
    return n


def lane_index(mesh: Mesh):
    """Inside a shard_map body over `mesh`: the linear index of this
    device's lane shard (row-major over the lane axes), for RNG folds.
    Time shards deliberately share the index — their lane draws must be
    bit-identical (the edge scan runs replicated across time shards)."""
    import jax.numpy as jnp
    idx = jnp.int32(0)
    for a in lane_axes(mesh):
        idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
    return idx


def glm_shardings(mesh: Mesh, state: GLMState, datas: tuple):
    """NamedShardings for (key, state, datas) of the sweep signature.

    Neuron-indexed arrays shard over 'neuron' (postsynaptic axis), time-major
    arrays over 'time'; network hyperparameters are small and replicated.
    """
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    rep = ns()
    state_sh = GLMState(
        A=ns(None, "neuron"),          # (pre, post): shard postsyn
        W=ns(None, "neuron", None),
        b=ns("neuron"),
        aux=jax.tree.map(lambda _: ns("neuron"), state.aux),
        net=jax.tree.map(lambda _: rep, state.net),
    )
    # Datasets whose T the mesh time axis does not divide stay unsharded
    # along time (replicated design, neuron-sharded observations) — the
    # sweep is still correct, just without time parallelism for that
    # dataset; shard_model warns loudly about the downgrade.
    n_time = mesh.shape.get("time", 1)
    data_sh = tuple(
        GLMData(Y=ns("time" if int(d.Y.shape[0]) % n_time == 0 else None,
                     "neuron"),
                Xf=ns("time" if int(d.Y.shape[0]) % n_time == 0 else None,
                      None),
                Xt=None if d.Xt is None
                else ns(None, "time" if int(d.Y.shape[0]) % n_time == 0
                        else None),
                Gg0=None if d.Gg0 is None else rep,
                Gfull=None if d.Gfull is None else rep,
                XtY=None if d.XtY is None else ns(None, "neuron"),
                llc=None if d.llc is None
                else jax.tree.map(lambda _: rep, d.llc))
        for d in datas)
    return rep, state_sh, data_sh


def make_sharded_sweep(sweep_fn, mesh: Mesh, state: GLMState, datas: tuple,
                       return_raw: bool = False):
    """jit the sweep with mesh shardings on inputs and outputs.

    Returns (jitted_fn, placed_state, placed_datas); with return_raw, also
    the UN-jitted mesh-scoped sweep callable (for callers that scan it
    inside their own jit, e.g. fit_compiled on a sharded model).
    """
    key_sh, state_sh, data_sh = glm_shardings(mesh, state, datas)
    diag_sh = {"log_likelihood": key_sh, "n_edges": key_sh}
    if hasattr(state.net, "hmc_accept"):
        diag_sh["hmc_accept"] = key_sh
    def sweep_in_mesh(*args):
        # Scoped trace-time context: the kernel dispatchers consult the
        # active mesh while the sweep traces (incl. retraces on new shapes).
        prev = active_mesh()
        set_active_mesh(mesh)
        try:
            return sweep_fn(*args)
        finally:
            set_active_mesh(prev)

    fn = jax.jit(
        sweep_in_mesh,
        in_shardings=(key_sh, state_sh, data_sh),
        out_shardings=(state_sh, diag_sh),
    )
    placed_state = jax.device_put(state, state_sh)
    placed_datas = jax.device_put(datas, data_sh)
    if return_raw:
        return fn, placed_state, placed_datas, sweep_in_mesh
    return fn, placed_state, placed_datas


def best_mesh_for(N: int, T=None, devices=None) -> Mesh:
    """Pick a mesh compatible with model size: the largest divisor of N that
    fits the device count goes on the neuron axis; remaining factor-of-2
    devices go on the time axis when the dataset length(s) T allow."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    Ts = [] if T is None else ([int(T)] if np.isscalar(T) else [int(t) for t in T])
    best = (1, 1)   # (n_time, n_neuron)
    nt = 1
    while nt <= n_dev and all(t % nt == 0 for t in Ts):
        for nn in range(1, n_dev // nt + 1):
            if N % nn == 0:
                # maximize devices used, then the neuron axis (cheaper comms)
                if (nt * nn, nn) > (best[0] * best[1], best[1]):
                    best = (nt, nn)
        nt *= 2
    n_time, n_neuron = best
    return make_mesh(n_time=n_time, n_neuron=n_neuron,
                     devices=devices[: n_time * n_neuron])


def shard_model(model, mesh: Mesh):
    """Re-target a NonlinearAutoregressiveModel onto a device mesh in place.

    After this, every resample_model() runs the SPMD sweep with the model's
    state and design tensors laid out across `mesh`.
    """
    from pyglm_tpu.models.sweep import make_gibbs_sweep
    n_neuron = mesh.shape["neuron"]
    if model.N % n_neuron != 0:
        raise ValueError(
            f"model N={model.N} is not divisible by the mesh neuron axis "
            f"({n_neuron}); use make_mesh(n_neuron=d) with d | N, or "
            f"best_mesh_for(N) to auto-select")
    sweep_fn = make_gibbs_sweep(
        model.observation, model.network, model.N, model.B,
        model.spike_and_slab,
        t_chunk=model._t_chunk, precision=model._precision)
    # Re-ingest existing datasets under the mesh (per-time-shard conv with
    # an L-bin halo exchange) so the design lives in sharded buffers from
    # the start instead of being scattered from one device's copy; datasets
    # registered AFTER shard() ingest shardedly in add_data directly.
    import jax.numpy as jnp
    from pyglm_tpu.ops.basis import design_matrix_sharded
    n_time = mesh.shape["time"]
    datas = []
    for d in model.datas:
        T = int(d.Y.shape[0])
        if T % n_time != 0 or T // n_time < model.L:
            # Validate T like N above — but warn instead of raising: the
            # sweep is still correct with an unsharded design, just slower
            # (it loses the sharded ingest AND the mesh-fused
            # spike-and-slab path, which needs T % n_time == 0).
            import warnings
            from pyglm_tpu.utils.utils import PerformanceWarning
            warnings.warn(
                f"shard(): dataset with T={T} keeps its UNSHARDED design "
                f"(needs T divisible by the mesh time axis {n_time} and a "
                f"shard of at least L={model.L} bins); the mesh sweep "
                f"will fall back to the staged spike-and-slab path — pad "
                f"or trim T to a multiple of {n_time}",
                PerformanceWarning, stacklevel=2)
        elif d.Gg0 is None and d.Gfull is None:
            Xf = design_matrix_sharded(d.Y, model.basis, mesh)
            d = d._replace(
                Xf=Xf, Xt=None if d.Xt is None else jnp.asarray(Xf.T))
        datas.append(d)
    datas = tuple(datas)
    fn, state, datas, raw = make_sharded_sweep(
        sweep_fn, mesh, model.state, datas, return_raw=True)
    model._sweep = fn
    model._sweep_raw = raw
    model.state = state
    model.datas = list(datas)
    model._mesh = mesh
    return model
