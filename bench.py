"""Headline benchmark: example-shaped QP solves/s on one GPU.

The workload of ``chip_smoke.py`` phase 2: 1,048,576 instances of the
in-repo stand-in for the reference ``example/`` problem (N=28, M=7,
:func:`pqp_for_mpc_tpu.models.example.example_problem`) solved to the
reference tolerances from the reference cold start (y0=1000) through
``solve_auto``.  Fails without a GPU.

Prints ONE JSON line:
  {"metric": "example_qp_solves_per_s", "value": ..., "unit": "solves/s",
   "device_kind": ..., "device_count": ..., "nvidia_smi": "name, power"}
"""

from __future__ import annotations

import json
import sys

import numpy as np

from chip_smoke import SCENARIO_CFG, compile_and_time, nvidia_smi

BATCH = 1 << 20


def main() -> int:
    import jax
    from pqp_for_mpc_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from pqp_for_mpc_tpu import SolverConfig, dualize
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.routing import route_solve, solve_auto

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 1
    cfg = SolverConfig(**SCENARIO_CFG)
    primal = example_problem(BATCH, seed=0)
    dual = dualize(primal, theta_floor=cfg.theta_floor)
    res, compile_s, run_s = compile_and_time(
        lambda p, d: solve_auto(p, d, cfg=cfg), (primal, dual), reps=10)
    print(json.dumps({
        "metric": "example_qp_solves_per_s",
        "value": BATCH / run_s,
        "unit": "solves/s",
        "batch": BATCH,
        "engine": route_solve(dual.n_con, BATCH, False, cfg),
        "mean_iters": float(np.asarray(res.iters).mean()),
        "converged_frac": float(np.asarray(res.converged).mean()),
        "seconds_per_batch": run_s,
        "compile_s": compile_s,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": nvidia_smi(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
