"""Temporal-parallel (associative-scan) vs sequential stage-wise PQP.

Measures the per-iteration cost of `solve_stagewise` at H=512 with both
KKT recursion modes at a FIXED iteration budget (impossible tolerances
so every lane exhausts max_iters — equal work by construction, the
reference's own fixed-iteration benchmarking methodology,
testing/CPU version/PQP_CPU_test.c:717).

Run: ``python benchmarks/bench_pscan.py``; one JSON line per batch size.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import jax
    import jax.numpy as jnp

    from pqp_for_mpc_tpu import SolverConfig
    from pqp_for_mpc_tpu.models import MPCSpec, double_integrator
    from pqp_for_mpc_tpu.models.stagewise import (solve_stagewise,
                                                  stagewise_dual)
    from pqp_for_mpc_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    H, iters = 512, 2048
    spec = MPCSpec(
        plant=double_integrator(), horizon=H,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    cfg = SolverConfig(max_iters=iters, check_every=16, accel_every=8,
                       y0=0.01, eaj=0.0, erj=0.0, erc=0.0, eac=0.0,
                       strict_weak_duality=False)
    sd = stagewise_dual(spec, theta_floor=cfg.theta_floor, pscan=True)

    for B in (32, 256):
        rng = np.random.default_rng(0)
        x0 = jnp.asarray(rng.uniform(-2, 2, (2, B)).astype(np.float32))
        dt = {}
        for pscan in (False, True):
            def run():
                jax.block_until_ready(
                    solve_stagewise(sd, x0, cfg=cfg, pscan=pscan))
            run()    # compile + warm-up
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                times.append(time.perf_counter() - t0)
            dt[pscan] = min(times)
        print(json.dumps({
            "metric": "stagewise_pscan_speedup", "H": H, "B": B,
            "fixed_iters": iters,
            "seq_us_per_iter": dt[False] / iters * 1e6,
            "pscan_us_per_iter": dt[True] / iters * 1e6,
            "speedup": dt[False] / dt[True],
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind}))


if __name__ == "__main__":
    main()
