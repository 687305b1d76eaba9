"""Automatic solve-engine routing.

Three engines solve a batch of PQP duals:

* ``"xla"`` — :func:`~pqp_for_mpc_tpu.solver.solve_batched`, the masked
  XLA while loop; every shape, geometry and configuration;
* ``"fused"`` — :func:`~pqp_for_mpc_tpu.ops.solve_kernel.solve_fused`,
  the whole-solve GPU kernel (Pallas through Triton);
* ``"mixed"`` — :func:`~pqp_for_mpc_tpu.solver.solve_mixed`, a bfloat16
  bulk phase then float32 certification.

:func:`route_solve` returns ``"fused"`` only in the regime where the
kernel was measured faster than ``solve_batched`` end to end on one
H100 (700 W): a GPU, shared geometry, a cold start, a configuration the
kernel certifies (no acceleration, no ``feas_from_dual_gradient``),
``16 < N <= 64`` and at least 262,144 lanes.  There it measured 0.244 s
against 0.461 s at N=28, B=1,048,576 and 1.23x at N=64, B=262,144
(``chip_smoke.py`` phase 3).  Everything else is ``"xla"``: off the GPU
there is no kernel to choose, and ``"mixed"`` is not yet measured
against float32 across N on this card, so it stays an explicit choice.
The reference has no routing: its five variants are the same pipeline
at five optimization levels, chosen at compile time.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from pqp_for_mpc_tpu.config import SolverConfig
from pqp_for_mpc_tpu.problem import PrimalQP
from pqp_for_mpc_tpu.dual import DualQP
from pqp_for_mpc_tpu.ops.solve_kernel import (MAX_FUSED_N, fused_supports,
                                            solve_fused)
from pqp_for_mpc_tpu.solver import (SolveResult, _as2d, retry_cold_solve,
                                    solve_batched, solve_mixed)

ENGINES = ("xla", "fused", "mixed")

#: smallest N and batch at which the kernel was measured (N=28 and
#: N=64 at B >= 262,144); below them it is unmeasured and not chosen
FUSED_MIN_N = 17
FUSED_MIN_BATCH = 1 << 18


def route_solve(n_con: int, batch: int, distinct: bool,
                cfg: SolverConfig, platform: Optional[str] = None,
                warm: bool = False) -> str:
    """Pick the solve engine for one problem shape.

    Pure decision function (no device work): ``n_con`` = dual dimension
    N, ``batch`` = instance count B, ``distinct`` = per-instance Qd
    (3-D), ``platform`` = JAX backend name (``None`` = ask JAX),
    ``warm`` = a warm start Y0 is provided.  Returns one of
    :data:`ENGINES`.
    """
    if platform is None:
        platform = jax.default_backend()
    if (platform == "gpu" and not distinct and not warm
            and FUSED_MIN_N <= n_con <= MAX_FUSED_N
            and batch >= FUSED_MIN_BATCH
            and not cfg.accel_every and not cfg.feas_from_dual_gradient):
        return "fused"
    return "xla"


def solve_auto(primal: PrimalQP, dual: DualQP,
               Y0: Optional[jax.Array] = None,
               cfg: SolverConfig = SolverConfig(),
               retry_cold: bool = False,
               engine: Optional[str] = None) -> SolveResult:
    """Solve through the engine :func:`route_solve` picks for this
    problem (pass ``engine`` to choose one).  Accepts everything
    :func:`solve_batched` does — shared or distinct geometry, warm
    starts, certify-or-recover ``retry_cold``.

    Safe under ``jit``: the routing decision is made at trace time from
    static shapes and the static ``cfg``.
    """
    distinct = dual.Qd.ndim == 3
    N = dual.n_con
    B = dual.Qd.shape[0] if distinct else _as2d(dual.Fd).shape[1]
    if Y0 is not None and _as2d(Y0).shape[1] > B:
        B = _as2d(Y0).shape[1]
    if engine is None:
        engine = route_solve(N, B, distinct, cfg, warm=Y0 is not None)
        if engine == "fused" and not fused_supports(dual, cfg):
            # a split-free dual (dualize(materialize_splits=False))
            engine = "xla"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "fused" and jax.default_backend() != "gpu":
        raise ValueError(
            f"engine 'fused' is a GPU kernel and this process is on "
            f"{jax.default_backend()!r}; use engine='xla' or 'mixed' "
            "(tests run the kernel through solve_fused(interpret=True))")

    if engine == "xla":
        return solve_batched(primal, dual, Y0=Y0, cfg=cfg,
                             retry_cold=retry_cold and Y0 is not None)
    if engine == "mixed":
        fn = lambda y0: solve_mixed(primal, dual, Y0=y0, cfg=cfg)
    else:
        fn = lambda y0: solve_fused(primal, dual, Y0=y0, cfg=cfg)

    if retry_cold and Y0 is not None:
        Y_warm = jnp.maximum(_as2d(Y0), 0.0)
        if Y_warm.shape[1] == 1 and B > 1:
            Y_warm = jnp.broadcast_to(Y_warm, (N, B))
        Y_cold = jnp.full((N, B), cfg.y0, jnp.float32)
        return retry_cold_solve(fn, Y_warm, Y_cold)
    return fn(Y0)
