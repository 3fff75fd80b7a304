"""Device mesh and axis-naming layer (SURVEY §2.4).

The reference has no distribution of any kind (single tf.Session,
train.py:109); this module is the thin backend-agnostic layer SURVEY
prescribes: mesh creation, axis naming, multi-host init. Everything above it
(trainer, model sharding hints) speaks named axes only:

* ``data`` — batch (data parallel); gradients all-reduce via the compiler
  from sharding annotations, never by hand.
* ``k``    — hypothesis lanes (the model's sequence-parallel analogue,
  SURVEY §2.3): K-lane tensors shard their lane dim across devices.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
K_AXIS = "k"


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Multi-host bring-up (jax.distributed). No-op for single-process runs."""
    if coordinator:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(data: int | None = None, k: int = 1,
              devices: list | None = None) -> Mesh:
    """Build a (data, k) mesh over the first data*k devices, in order.
    data=None -> use all remaining devices. Every GPU of a host reaches
    every other at the same rate, so the device order needs no topology
    search."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None:
        assert n % k == 0, f"{n} devices not divisible by k={k}"
        data = n // k
    assert data * k <= n, f"mesh {data}x{k} exceeds {n} devices"
    devs = np.asarray(devices[: data * k]).reshape(data, k)
    return Mesh(devs, (DATA_AXIS, K_AXIS))


def under_mesh(mesh: Mesh, fn):
    """Wrap fn (a jitted step) so that it traces and runs with `mesh` as
    the context mesh: the model's shard_hint constraints
    (parallel/sharding.py) only take effect under one, so without it the
    K lanes would never shard over the 'k' axis. fn.lower is wrapped the
    same way, for callers that compile ahead of time."""
    def in_mesh(method):
        @functools.wraps(method)
        def call(*args, **kwargs):
            with jax.set_mesh(mesh):
                return method(*args, **kwargs)
        return call

    wrapped = in_mesh(fn)
    wrapped.lower = in_mesh(fn.lower)
    return wrapped


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Batches shard their leading (B) dim over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def local_batch_rows(sharding: NamedSharding, global_batch: int) -> np.ndarray:
    """Global-batch row indices owned by THIS process under `sharding`.

    Multi-host data feeding (SURVEY §2.4): each host materializes only its
    rows of the logically-global batch and `jax.make_array_from_process_local_data`
    assembles the global array — no whole-array device_put (which would
    require every host to hold every row). Rows come back ascending, the
    order make_array_from_process_local_data expects process-local data in.
    """
    idx_map = sharding.addressable_devices_indices_map((global_batch,))
    rows = np.unique(np.concatenate(
        [np.arange(*sl[0].indices(global_batch)) for sl in idx_map.values()]))
    return rows.astype(np.int64)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
