"""Device-mesh construction.

The reference has no multi-device story at all (single default CUDA
stream; SURVEY.md §2.3).  Here the scaling axes are:

* ``data``  — independent QP instances (scenarios / initial states);
* ``model`` — rows of the dual Hessian Qd for large-N instances
  (the TP analog; see :mod:`pqp_for_mpc_tpu.parallel.sharded`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Create a ``(data, model)`` mesh over the available devices.

    ``data=None`` uses all remaining devices after the model axis.
    The model axis is laid out innermost.  The four GPUs of one host are
    joined all to all by NVLink, so within a host the layout follows the
    algorithm only.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    arr = np.array(devices[: data * model]).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding for (feature, batch)-layout arrays: batch on the trailing
    axis, sharded over the data axis."""
    return NamedSharding(mesh, P(None, axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
