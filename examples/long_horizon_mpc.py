"""Long-horizon MPC with the matrix-free stage-wise backend.

The reference hard-wires pHorizon=1 (PQP_CPU.c:13-17); the condensed
formulation that escapes it densifies at O((4*H*nu)^2).  This example
runs a horizon-H receding-horizon loop through
``MPCController(backend="stagewise")`` — O(H) memory, temporally
parallelized Riccati/KKT recursions (lax.associative_scan), tolerances
auto-set to the horizon's float32 certification floor
(config.stagewise_mpc_config), and certify-or-recover cold retries for
any step whose warm start fails certification.

Usage: python examples/long_horizon_mpc.py [horizon] [steps]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run me from anywhere

import sys
import time

import numpy as np


def main() -> None:
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController
    from pqp_for_mpc_tpu.models import double_integrator

    H = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 30

    spec = MPCSpec(
        plant=double_integrator(), horizon=H,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))

    # retry_cold compiles ONE solve instance at any horizon
    # (solver.retry_cold_solve)
    ctrl = MPCController(spec, backend="stagewise", warm_start="shift",
                         retry_cold=True)
    assert ctrl.data is None          # the condensed blocks never exist

    x0 = np.array([2.0, 0.0], np.float32)
    ctrl.rollout_jit(x0, steps=steps)             # compile
    t0 = time.perf_counter()
    out = ctrl.rollout_jit(x0, steps=steps)
    dt = time.perf_counter() - t0

    print(f"H={H}: {steps} steps in {dt:.3f}s "
          f"({steps / dt:.1f} steps/s), "
          f"certified {100 * out['converged'].mean():.0f}%, "
          f"mean {out['iters'].mean():.0f} iters/step, "
          f"|x_final| = {np.linalg.norm(out['x'][-1]):.3f}")


if __name__ == "__main__":
    main()
