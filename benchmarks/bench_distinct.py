"""Distinct-geometry batch benchmark: the XLA einsum path of
``solve_batched`` on a GPU.

Workload: B fully distinct instances (one random geometry each — the
shape of the reference's generator benchmark,
testing/test_generator.c:997-998) at M=100, N=400, solved to
convergence.

Usage:  python benchmarks/bench_distinct.py [B] [N] [M]
Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_instances(B, M, N, seed=0, gaussian_gp=False):
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.problem import PrimalQP

    rng = np.random.default_rng(seed)
    # well-conditioned SPD Qp per instance (the reference generator's
    # diagonal Qp is a special case; dense is the harder workload)
    L = rng.standard_normal((B, M, M)).astype(np.float32) / np.sqrt(M)
    Qp = np.einsum("bij,bkj->bik", L, L) + 2.0 * np.eye(M, dtype=np.float32)
    if gaussian_gp:
        # the large-N workload: {-1,0,1} Gp rowsums at N=4096 drive
        # theta ~10x up and the accel-free multiplicative update needs
        # >80k iterations; gaussian Gp with a strongly regularized Qp
        # (io.generator.gaussian_batch's family) converges far sooner
        Qp = Qp + (M - 2.0) * np.eye(M, dtype=np.float32)
        Qp_inv = np.linalg.inv(Qp).astype(np.float32)
        Gp = rng.standard_normal((B, N, M)).astype(np.float32)
        Fp = (rng.standard_normal((M, B)) * 3).astype(np.float32)
        Mp = np.zeros(B, np.float32)
        Kp = rng.uniform(1.0, 10.0, (N, B)).astype(np.float32)
        return PrimalQP(Qp=jnp.asarray(Qp), Qp_inv=jnp.asarray(Qp_inv),
                        Fp=jnp.asarray(Fp), Mp=jnp.asarray(Mp),
                        Gp=jnp.asarray(Gp), Kp=jnp.asarray(Kp))
    Qp_inv = np.linalg.inv(Qp).astype(np.float32)
    Gp = rng.integers(-1, 2, (B, N, M)).astype(np.float32)
    Fp = (rng.standard_normal((M, B)) * 3).astype(np.float32)
    Mp = rng.standard_normal(B).astype(np.float32)
    Kp = rng.uniform(1.0, 8.0, (N, B)).astype(np.float32)
    return PrimalQP(Qp=jnp.asarray(Qp), Qp_inv=jnp.asarray(Qp_inv),
                    Fp=jnp.asarray(Fp), Mp=jnp.asarray(Mp),
                    Gp=jnp.asarray(Gp), Kp=jnp.asarray(Kp))


def main() -> None:
    import jax
    from pqp_for_mpc_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from pqp_for_mpc_tpu.config import SolverConfig
    from pqp_for_mpc_tpu.dual import dualize_distinct
    from pqp_for_mpc_tpu.solver import solve_batched
    from pqp_for_mpc_tpu.utils.profiling import timed

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_distinct.py: no GPU (JAX found {dev.platform})")
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 400
    M = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    primal = make_instances(B, M, N)
    cfg = SolverConfig(max_iters=20_000, check_every=8,
                       strict_weak_duality=False)
    dual = dualize_distinct(primal, theta_floor=cfg.theta_floor)
    dt, res = timed(lambda: solve_batched(primal, dual, cfg=cfg))
    print(json.dumps({
        "metric": "distinct_geometry_solves_per_s",
        "value": B / dt,
        "unit": "solves/s",
        "batch": B, "N": N, "M": M, "seconds": dt,
        "iters_mean": float(np.asarray(res.iters).mean()),
        "converged_frac": float(np.asarray(res.converged).mean()),
        "device_kind": dev.device_kind,
    }))


if __name__ == "__main__":
    main()
