"""Multi-host initialization and host-aware work placement.

The reference is strictly single-process (SURVEY.md section 2.3: no
torch.distributed / NCCL / MPI anywhere; reference mnle.py:86 pins
``num_workers=1``). This module is the multi-host tier: one call to
:func:`initialize_multihost` at program start turns a fleet of hosts (one
process per host, each owning its local GPUs) into a single JAX runtime
whose ``jax.devices()`` spans them all; every mesh helper in :mod:`.mesh`
then works unchanged because XLA compiles the collectives (NCCL on GPUs).

How the SBI workloads map to hosts:

* **Simulation / training** — the trial axis is sharded over the *global*
  device list (``global_mesh()``); XLA inserts the gradient ``psum``. No
  code changes beyond the mesh.
* **SBC** — the batched SBC driver folds datasets into the chain axis
  (mnle.py ``_run_sbc_batched``); passing ``mesh=global_mesh()`` shards that
  folded axis, so each host's devices sample their own block of datasets
  with zero cross-host collectives (datasets are independent). Group sizes
  should be a multiple of the global device count.
* **MCMC chains** — embarrassingly parallel; same sharding as SBC.

Single-process environments (the CI fake-device mesh, one host with one or
four GPUs) skip ``jax.distributed.initialize`` entirely — the helpers then
degrade to the local device list, so this module is safe to call
unconditionally. Nothing tells JAX of a cluster by itself: a multi-host run
passes ``coordinator_address`` (``host:port``), ``num_processes`` and
``process_id`` (or the environment variables below). The wiring follows the
standard ``jax.distributed`` contract and is exercised in single-process mode
by ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize_multihost", "global_mesh", "is_multihost", "process_info"]

_initialized = False


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> dict:
    """Join (or skip joining) a multi-host JAX runtime; returns process info.

    Arguments default from the standard environment variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``)
    so launchers can configure purely via env. When neither arguments nor
    env are present this is a no-op (single-process mode) — the function is
    safe to call at every entry point.
    """
    global _initialized
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None or _initialized:
        return process_info()

    kwargs = dict(coordinator_address=coordinator_address)
    num_processes = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else os.environ.get(
        "JAX_PROCESS_ID"
    )
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return process_info()


def is_multihost() -> bool:
    return jax.process_count() > 1


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
    }


def global_mesh(axis_name: str = "data") -> Mesh:
    """1-D mesh over ALL global devices (every host's chips).

    In single-process mode this equals ``mesh.default_mesh()``; under
    ``initialize_multihost`` it spans the pod, and arrays placed with
    ``shard_leading`` become globally-sharded jax.Arrays (each host
    materializes only its addressable shards).
    """
    return Mesh(np.array(jax.devices()), (axis_name,))
