"""Seeded in-repo stand-in for the reference's ``example/`` problem.

The reference ships one condensed-MPC instance as text files: a
29-state, 7-input building plant at horizon 1, so a primal of M=7 and
a dual of N=28 box and slew rows (PQP_CPU.c:13-17, 940-941).  That data
is not part of this repository.  :func:`example_problem` builds a
problem of the same shape from :func:`~pqp_for_mpc_tpu.models.plants.thermal_rc`
(29 rooms, 7 heaters, ambient disturbance), condensed at H=1 with an
input box and slew bounds, for a batch of initial room temperatures
drawn from ``seed``.  It is the headline workload of ``bench.py`` and
``chip_smoke.py`` and the small problem of the tests.
"""

from __future__ import annotations

import numpy as np

from pqp_for_mpc_tpu.models.mpc import MPCSpec, condense
from pqp_for_mpc_tpu.models.plants import thermal_rc
from pqp_for_mpc_tpu.problem import PrimalQP

#: heater power box and slew bound (the reference example's Kp is 20)
U_BOUND = 20.0
DU_BOUND = 10.0


def example_spec(n_rooms: int = 29, n_heaters: int = 7) -> MPCSpec:
    """thermal_rc(29 rooms, 7 heaters) at H=1: drive the heated rooms to
    ambient under |u| <= 20 and |u - u_prev| <= 10 with u_prev = 0.
    Other sizes give M = n_heaters and N = 4*n_heaters."""
    plant = thermal_rc(n_rooms=n_rooms, n_heaters=n_heaters)
    nu, ny = plant.n_input, plant.n_output
    return MPCSpec(
        plant=plant, horizon=1,
        Qy=np.eye(ny, dtype=np.float32),
        R=0.1 * np.eye(nu, dtype=np.float32),
        r=np.zeros(ny, np.float32),
        u_min=np.full(nu, -U_BOUND, np.float32),
        u_max=np.full(nu, U_BOUND, np.float32),
        du_max=np.full(nu, DU_BOUND, np.float32))


def example_states(batch: int | None = None, seed: int = 0,
                   n_rooms: int = 29) -> np.ndarray:
    """Room temperatures relative to ambient: a seeded nominal state
    ``(n_rooms,)`` and, with ``batch``, ``(n_rooms, batch)`` states scattered
    around it.  At this spread the optimal heater powers stay inside
    the box and slew bounds, as in the reference example, and every
    lane certifies at the reference tolerances."""
    rng = np.random.default_rng(seed)
    x_nom = rng.uniform(0.0, 0.5, n_rooms).astype(np.float32)
    if batch is None:
        return x_nom
    return x_nom[:, None] + rng.normal(0.0, 0.3, (n_rooms, batch)).astype(
        np.float32)


def example_problem(batch: int | None = None, seed: int = 0,
                    n_rooms: int = 29, n_heaters: int = 7) -> PrimalQP:
    """The example-shaped primal QP (M=7, N=28): one instance at the
    nominal state, or ``batch`` instances (``Fp (M, batch)``,
    ``Mp (batch,)``) sharing the constraint geometry."""
    import jax.numpy as jnp

    data = condense(example_spec(n_rooms, n_heaters))
    x = example_states(batch, seed, n_rooms)
    return data.assemble(x=jnp.asarray(x), Qp=data.qp())
