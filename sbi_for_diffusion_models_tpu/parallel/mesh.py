"""Device-mesh scale-out: sharded simulation, data-parallel training, and
chain-sharded MCMC.

The reference has no parallelism of any kind — single process, serial batch
loops, ``num_workers=1`` (reference: data_simulator.py:48, mnle.py:86; see
SURVEY.md section 2.3). This module is the scale-out tier:

* **Trial axis** is the data-parallel axis for simulation: the DDM scan kernel
  is elementwise over trials, so sharding theta/pulses over the mesh runs with
  zero collectives.
* **MNLE training** is data-parallel via sharding constraints: batch sharded,
  params replicated; XLA inserts the gradient ``psum`` (NCCL on GPUs).
* **MCMC chains** shard over the mesh (chains are embarrassingly parallel);
  same for SBC datasets.

All entry points take an optional mesh and work on any device count, including
the single-chip and the CPU fake-device meshes used in CI.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "default_mesh",
    "shard_leading",
    "replicate",
    "pad_to_multiple",
    "sharded_simulate",
    "make_dp_train_step",
    "sharded_run_nuts",
]


def default_mesh(
    n_devices: Optional[int] = None, axis_name: str = "data"
) -> Mesh:
    """1-D mesh over the first ``n_devices`` (default: all) devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[: int(n_devices)]
    return Mesh(np.array(devices), (axis_name,))


def shard_leading(arr, mesh: Mesh, axis_name: str = "data"):
    """Put ``arr`` on the mesh with its leading axis sharded."""
    spec = P(axis_name, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (e.g. params) across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def pad_to_multiple(arr, multiple: int, axis: int = 0):
    """Pad axis up to a multiple (edge-replicated); returns (padded, true_n).

    Sharding requires the global axis divisible by the mesh size; padded rows
    are sliced away after the compute.
    """
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return jnp.pad(arr, pad, mode="edge"), n


def sharded_simulate(
    simulate_fn,
    theta,
    pulse_sides,
    key,
    mesh: Optional[Mesh] = None,
    axis_name: str = "data",
    **kwargs,
):
    """Run a batched trial simulator with the trial axis sharded over a mesh.

    ``simulate_fn(theta, pulse_sides, key, **kwargs) -> (N, 2)`` — e.g.
    ``ops.ddm_scan.ddm_rt_choice_scan``. The kernel is elementwise over
    trials, so XLA partitions it with no communication.
    """
    if mesh is None:
        mesh = default_mesh(axis_name=axis_name)
    n_dev = mesh.devices.size
    theta = jnp.asarray(theta, jnp.float32)
    pulse_sides = jnp.asarray(pulse_sides, jnp.float32)
    theta_p, n = pad_to_multiple(theta, n_dev)
    pulses_p, _ = pad_to_multiple(pulse_sides, n_dev)
    theta_s = shard_leading(theta_p, mesh, axis_name)
    pulses_s = shard_leading(pulses_p, mesh, axis_name)
    out = simulate_fn(theta_s, pulses_s, key, **kwargs)
    return out[:n]


def make_dp_train_step(loss_fn, tx, mesh: Mesh, axis_name: str = "data"):
    """Data-parallel training step: batch sharded, params replicated.

    ``loss_fn(params, x, z) -> scalar``. Returns a jitted
    ``step(params, opt_state, x, z) -> (params, opt_state, loss)`` whose
    gradient all-reduce XLA lowers to a ``psum`` (NCCL on GPUs).
    """
    import optax

    batch_sharding = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())

    @partial(
        jax.jit,
        in_shardings=(rep, rep, batch_sharding, batch_sharding),
        out_shardings=(rep, rep, rep),
    )
    def step(params, opt_state, x, z):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, z)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def sharded_run_nuts(
    key,
    logp_fn,
    init_u,
    mesh: Optional[Mesh] = None,
    axis_name: str = "chains",
    **nuts_kwargs,
):
    """run_nuts with the chain axis sharded over the mesh.

    Chains are independent, so this is collective-free; ``init_u`` is
    (num_chains, D) with num_chains a multiple of the mesh size (padded up if
    not; padded chains are dropped from the output).
    """
    from ..inference.nuts import run_nuts

    if mesh is None:
        mesh = default_mesh(axis_name=axis_name)
    n_dev = mesh.devices.size
    init_p, n_chains = pad_to_multiple(jnp.asarray(init_u, jnp.float32), n_dev)
    init_s = shard_leading(init_p, mesh, axis_name)
    samples, info = run_nuts(key, logp_fn, init_s, **nuts_kwargs)
    samples = samples[:n_chains]
    info = jax.tree.map(
        lambda a: a[:n_chains] if hasattr(a, "ndim") and a.ndim >= 1 else a, info
    )
    return samples, info
