"""Device mesh construction.

The reference is single-process/single-thread (SURVEY.md section 2.7); this
framework's scale-out axes are:

- "batch": data parallelism over LP instances (the netlib sweep — the
  reference's evaluate/ workload run per-problem),
- "model": tensor parallelism within one large LP — A's column dimension is
  sharded so the normal-equations syrk A D^-1 A' becomes per-shard partial
  products all-reduced across the devices (GSPMD inserts the psum; NCCL
  carries it over NVLink on a GPU host).

Following the standard recipe: pick a mesh, annotate shardings with
NamedSharding, jit, and let XLA place the collectives.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """A ("batch", "model") mesh over the first n_devices devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by model_parallel="
            f"{model_parallel}")
    grid = np.asarray(devices).reshape(n_devices // model_parallel,
                                       model_parallel)
    return Mesh(grid, ("batch", "model"))


def batch_sharding(mesh: Mesh, *names: str) -> NamedSharding:
    """NamedSharding with leading 'batch' axis and given trailing specs."""
    return NamedSharding(mesh, P("batch", *names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
