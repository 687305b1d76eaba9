"""Run all five BASELINE.json benchmark configurations on one GPU, in
this one process, and emit one JSON record per line.  Timing: minimum
over repeats of work that ends in ``block_until_ready``
(utils.profiling.timed).  The example problem is the in-repo stand-in
(models.example).  Fails without a GPU.

    python benchmarks/run_all.py [--repeats 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# runnable from any cwd
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_auto
    from pqp_for_mpc_tpu.models import (MPCSpec, MPCController, condense,
                                        random_stable, double_integrator)
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.solver import solve_batched
    from pqp_for_mpc_tpu.utils.cache import enable_persistent_cache
    from pqp_for_mpc_tpu.utils.profiling import timed

    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"run_all.py: no GPU (JAX found {dev.platform})")
    emit = lambda **kw: print(json.dumps(
        dict(device_kind=dev.device_kind, **kw)), flush=True)
    time_it = lambda fn: timed(fn, repeats=args.repeats)
    rng = np.random.default_rng(0)

    # ---- config 1: single example QP to convergence (parity + fast) ----
    primal1 = example_problem()
    for tag, cfg in [
        ("parity", SolverConfig(max_iters=5000, check_every=1)),
        ("fast", SolverConfig(max_iters=5000, check_every=4,
                              accel_every=4, y0=1.0)),
    ]:
        dual = dualize(primal1)
        dt, res = time_it(lambda: solve_batched(primal1, dual, cfg=cfg))
        emit(config=1, mode=tag, iters=int(np.asarray(res.iters)[0]),
             converged=bool(np.asarray(res.converged).all()),
             seconds=dt)

    # ---- config 2: example QP, batch 1024 initial states, 1 GPU ----
    B = 1024
    primal2 = example_problem(B, seed=0)
    dual2 = dualize(primal2)
    cfg2 = SolverConfig(max_iters=5000, check_every=8)
    solve2 = jax.jit(lambda p, d: solve_auto(p, d, cfg=cfg2))
    dt, res = time_it(lambda: solve2(primal2, dual2))
    emit(config=2, batch=B, seconds=dt,
         solves_per_s=B / dt,
         converged=int(np.asarray(res.converged).sum()))

    # ---- config 3: horizon-50, 12-state/4-input condensed MPC ----
    plant = random_stable(12, 4, seed=7)
    spec3 = MPCSpec(
        plant=plant, horizon=50,
        Qy=np.eye(plant.n_output, dtype=np.float32),
        R=0.1 * np.eye(4, dtype=np.float32),
        r=np.zeros(plant.n_output, np.float32),
        u_min=-2 * np.ones(4, np.float32), u_max=2 * np.ones(4, np.float32),
        du_max=np.ones(4, np.float32))
    d3 = condense(spec3)
    B3 = 256
    x3 = rng.uniform(-0.5, 0.5, (12, B3)).astype(np.float32)
    primal3 = d3.assemble(x=jnp.asarray(x3), Qp=d3.qp())
    cfg3 = SolverConfig(erc=1e-4, eac=1e-4, eaj=1e-3, erj=1e-3, y0=0.01,
                        check_every=8, accel_every=4,
                        strict_weak_duality=False, max_iters=50_000)
    dual3 = dualize(primal3, theta_floor=cfg3.theta_floor)
    dt, res = time_it(lambda: solve_batched(primal3, dual3, cfg=cfg3))
    emit(config=3, M=d3.n_var, N=d3.n_con, batch=B3, seconds=dt,
         solves_per_s=B3 / dt,
         iters_mean=round(float(np.asarray(res.iters).mean()), 1),
         converged=int(np.asarray(res.converged).sum()))

    # ---- config 4: 1000-step warm-started receding-horizon rollout ----
    spec4 = MPCSpec(
        plant=double_integrator(), horizon=16,
        Qy=np.eye(1, dtype=np.float32), R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32), u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    ctrl = MPCController(spec4)
    ctrl.rollout_jit(np.array([2.0, 0.0], np.float32), steps=1000)  # compile
    t0 = time.perf_counter()
    out = ctrl.rollout_jit(np.array([2.0, 0.0], np.float32), steps=1000)
    dt = time.perf_counter() - t0
    emit(config=4, steps=1000, seconds=dt,
         steps_per_s=1000 / dt,
         converged=bool(out["converged"].all()),
         final_state_norm=float(np.linalg.norm(out["x"][-1])))

    # ---- config 5: 65k-scenario batch (one GPU; several via
    #      parallel.sharded.shard_batch) ----
    B5 = 65536
    primal5 = example_problem(B5, seed=0)
    dual5 = dualize(primal5)
    dt, res = time_it(lambda: solve2(primal5, dual5))
    emit(config=5, batch=B5, seconds=dt,
         solves_per_s=B5 / dt,
         converged=int(np.asarray(res.converged).sum()))


if __name__ == "__main__":
    main()
