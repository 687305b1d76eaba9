"""Multi-host SPMD entry points.

The reference is a single-process, single-GPU program (SURVEY.md §2.3);
this module is the new capability: run the batched/sharded solvers over a
multi-host GPU cluster (or a multi-process CPU ring for testing) with the
``data`` axis spanning hosts — each host feeds its local shard of the
scenario batch, GSPMD inserts the only cross-host collective (the global
``all(done)`` reduction, which XLA hands to NCCL).

Typical cluster usage, one process per host::

    import pqp_for_mpc_tpu.parallel.distributed as dist
    dist.initialize(coordinator_address="host0:1234",
                    num_processes=n_hosts, process_id=rank)
    mesh = dist.global_mesh(model=1)        # data axis spans all GPUs
    primal, dual = shard_batch(primal, dual, mesh)
    res = solve_batched(primal, dual, cfg=cfg)

Multi-process CPU testing (what tests/test_distributed.py does)::

    dist.initialize(coordinator_address="localhost:1234",
                    num_processes=2, process_id=rank,
                    local_device_count=4)
"""

from __future__ import annotations

import os
from typing import Optional

from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_count: Optional[int] = None) -> None:
    """``jax.distributed.initialize`` wrapper.

    On a GPU cluster pass ``coordinator_address`` (``host:port`` of
    process 0), ``num_processes`` and ``process_id``; without them
    ``jax.distributed.initialize`` must find a cluster environment it
    knows.  For CPU test rings, pass everything explicitly;
    ``local_device_count`` forces N virtual CPU devices per process
    (must run before any jax op).
    """
    import jax

    if local_device_count is not None:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", local_device_count)
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(model: int = 1, data: Optional[int] = None) -> Mesh:
    """A ``(data, model)`` mesh over ALL devices of the job (every
    process sees the same global mesh; arrays are addressed per-shard).
    The model axis is innermost, so its all-gathers stay within a
    host."""
    from pqp_for_mpc_tpu.parallel.mesh import make_mesh
    import jax

    return make_mesh(data=data, model=model, devices=jax.devices())


def process_local_batch_slice(global_batch: int) -> slice:
    """The half-open range of the global batch this process should
    materialize when feeding ``jax.make_array_from_process_local_data``."""
    import jax

    n = jax.process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{n} processes — pad the batch (silently dropping the "
            "remainder would under-solve)")
    per = global_batch // n
    r = jax.process_index()
    return slice(r * per, (r + 1) * per)
