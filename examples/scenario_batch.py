"""Monte-Carlo scenario fan-out: solve the MPC QP for thousands of
initial states at once (BASELINE config 2/5 — the capability the
single-instance reference lacks entirely), on the example-shaped
stand-in problem, through whichever engine ``solve_auto`` picks.

    python examples/scenario_batch.py [batch]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run me from anywhere

import sys
import time

import jax

from pqp_for_mpc_tpu import SolverConfig, dualize, solve_auto
from pqp_for_mpc_tpu.models.example import example_problem
from pqp_for_mpc_tpu.utils.cache import enable_persistent_cache


def main():
    enable_persistent_cache()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    primal = example_problem(B, seed=0)
    cfg = SolverConfig(max_iters=5000, check_every=8,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    dual = dualize(primal)
    solve = jax.jit(lambda p, d: solve_auto(p, d, cfg=cfg))

    jax.block_until_ready(solve(primal, dual))       # compile
    t0 = time.perf_counter()
    res = jax.block_until_ready(solve(primal, dual))
    dt = time.perf_counter() - t0
    print(res.stats())
    print(f"{B} scenarios in {dt*1e3:.1f} ms -> {B/dt:,.0f} solves/s")


if __name__ == "__main__":
    main()
