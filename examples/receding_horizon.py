"""Receding-horizon MPC closed loop, host-driven and fully-jitted.

The jitted path (``rollout_jit``) runs the plant, the constraint
rebuild, and the warm-started PQP solve for EVERY step inside one
``lax.scan`` dispatch.

    python examples/receding_horizon.py [steps]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run me from anywhere

import sys
import time

import numpy as np

from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator
from pqp_for_mpc_tpu.utils.cache import enable_persistent_cache


def main():
    enable_persistent_cache()
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    plant = double_integrator()
    spec = MPCSpec(
        plant=plant, horizon=16,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    ctrl = MPCController(spec)

    ctrl.rollout_jit(np.array([2.0, 0.0], np.float32), steps=steps)  # compile
    t0 = time.perf_counter()
    out = ctrl.rollout_jit(np.array([2.0, 0.0], np.float32), steps=steps)
    dt = time.perf_counter() - t0
    print(f"{steps} steps in {dt:.3f} s ({steps/dt:,.0f} steps/s); "
          f"final x = {out['x'][-1].round(4)}; "
          f"solver iters mean {out['iters'].mean():.0f} "
          f"max {out['iters'].max()}; all converged: "
          f"{bool(out['converged'].all())}")


if __name__ == "__main__":
    main()
